"""Kernel dependency graphs: precedence-aware scheduling inputs.

The paper's Algorithm 1 — and everything built on it through
``fastscore.greedy_order_fast`` / ``refine_order`` — assumes all
kernels are mutually *independent*.  Real model workloads are layer
graphs: within one request, attention feeds the MLP feeds the next
layer's mixer, so only kernels from *different* requests (or different
micro-batches) are actually free to co-schedule.  This module supplies
the graph abstraction the constrained scheduler
(:mod:`repro_torch.graph.constrained`) and the gated simulator
(:mod:`repro_torch.graph.streams`) consume:

* :class:`KernelGraph` — ``KernelProfile`` nodes plus precedence edges
  ``(u, v)`` meaning *u must complete before v may start*, with
  adjacency/indegree bookkeeping, cycle validation, topological-order
  checking and seeded random topological sampling (the paper's Fig. 1
  "random launch orders" baseline generalized to DAG workloads),
* :func:`trace_arch` — builds the graph a model config *implies*: it
  walks the per-layer work-item chain each serving request emits
  (mixer -> ffn -> mixer -> ... in layer order), emitting intra-request
  edges while leaving cross-request kernels independent.  The per-item
  roofline characterisation reuses the serving substrate's
  :func:`repro_torch.core.tpu.prefill_profile` / ``decode_profile`` with the
  layer's parameter share, so intensities stay consistent with what
  ``ServingEngine`` models for whole-request items.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass, field, replace
from typing import Iterable, Sequence

from ..core.resources import KernelProfile
from ..core.tpu import TpuWorkItem, decode_profile, prefill_profile
from ..models.common import ModelConfig

__all__ = ["KernelGraph", "TracedWorkload", "trace_arch",
           "arch_kv_bytes_per_token", "estimate_n_params"]


@dataclass
class KernelGraph:
    """A DAG of :class:`KernelProfile` nodes with precedence edges.

    Edges are index pairs ``(u, v)``: kernel ``u`` must *complete*
    before kernel ``v`` may start (data dependence, not mere launch
    ordering).  An empty edge set degenerates to the independent-batch
    case the rest of the repo schedules; ``greedy_order_dag`` is
    property-tested to reproduce ``greedy_order_fast`` exactly there.
    """

    kernels: list[KernelProfile]
    edges: set = field(default_factory=set)

    def __post_init__(self):
        self.kernels = list(self.kernels)
        given = self.edges
        self.edges = set()
        self._succs: list[list[int]] = [[] for _ in self.kernels]
        self._preds: list[list[int]] = [[] for _ in self.kernels]
        for u, v in given:
            self.add_edge(u, v)

    # -- construction ---------------------------------------------------
    def add_edge(self, u: int, v: int) -> None:
        n = len(self.kernels)
        if not (0 <= u < n and 0 <= v < n):
            raise ValueError(f"edge ({u}, {v}) out of range for n={n}")
        if u == v:
            raise ValueError(f"self-edge ({u}, {v})")
        if (u, v) in self.edges:
            return
        self.edges.add((u, v))
        self._succs[u].append(v)
        self._preds[v].append(u)

    # -- topology -------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.kernels)

    def succs(self, u: int) -> list[int]:
        return list(self._succs[u])

    def preds(self, v: int) -> list[int]:
        return list(self._preds[v])

    def indegrees(self) -> list[int]:
        return [len(p) for p in self._preds]

    def validate(self) -> None:
        """Raise ``ValueError`` if the edge set contains a cycle."""
        indeg = self.indegrees()
        ready = [i for i in range(self.n) if indeg[i] == 0]
        seen = 0
        while ready:
            u = ready.pop()
            seen += 1
            for v in self._succs[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    ready.append(v)
        if seen != self.n:
            raise ValueError("precedence edges contain a cycle")

    def index_of(self) -> dict[int, int]:
        """``id(kernel) -> node index`` (profiles are unique objects)."""
        return {id(k): i for i, k in enumerate(self.kernels)}

    def edges_by_id(self) -> set:
        """Edge set keyed by kernel object identity, for consumers that
        see reordered kernel lists (simulators, stream assignment)."""
        ks = self.kernels
        return {(id(ks[u]), id(ks[v])) for u, v in self.edges}

    def is_topological(self, order: Sequence[KernelProfile]) -> bool:
        """True iff ``order`` is a permutation of the graph's kernels
        in which every edge points forward."""
        if len(order) != self.n:
            return False
        idx = self.index_of()
        pos: dict[int, int] = {}
        for p, k in enumerate(order):
            i = idx.get(id(k))
            if i is None or i in pos:
                return False
            pos[i] = p
        return all(pos[u] < pos[v] for u, v in self.edges)

    # -- random topological orders (Fig. 1 baseline on DAGs) ------------
    def random_topological_order(
            self, rng: _random.Random) -> list[KernelProfile]:
        """One uniform-tie-break Kahn order (not uniform over all
        topological orders, but unbiased among the ready frontier at
        every step — the natural 'random legal launch order')."""
        indeg = self.indegrees()
        ready = [i for i in range(self.n) if indeg[i] == 0]
        out: list[KernelProfile] = []
        while ready:
            u = ready.pop(rng.randrange(len(ready)))
            out.append(self.kernels[u])
            for v in self._succs[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    ready.append(v)
        if len(out) != self.n:
            raise ValueError("precedence edges contain a cycle")
        return out

    def random_topological_orders(self, n: int, seed: int = 0
                                  ) -> list[list[KernelProfile]]:
        rng = _random.Random(seed)
        return [self.random_topological_order(rng) for _ in range(n)]

    def schedule(self, device):
        """Convenience: the constrained greedy over this graph."""
        from .constrained import greedy_order_dag
        return greedy_order_dag(self.kernels, device, edges=self.edges)


# ---------------------------------------------------------------------------
# Architecture tracing: config -> per-layer work-item chains
# ---------------------------------------------------------------------------

def _attn_params(cfg: ModelConfig) -> float:
    d = cfg.d_model
    if cfg.attn_type == "mla":
        q_in = cfg.q_lora_rank or d
        q = (d * cfg.q_lora_rank if cfg.q_lora_rank else 0.0) + \
            q_in * cfg.n_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
        kv = d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) + \
            cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_head_dim +
                                              cfg.v_head_dim)
        o = cfg.n_heads * cfg.v_head_dim * d
        return float(q + kv + o)
    return float(d * cfg.n_heads * cfg.head_dim * 2 +
                 d * cfg.n_kv_heads * cfg.head_dim * 2)


def _mixer_params(cfg: ModelConfig, i: int) -> float:
    d = cfg.d_model
    kind = cfg.layer_kind(i)
    if kind == "attn":
        return _attn_params(cfg)
    if kind == "mamba":
        di = cfg.mamba_d_inner
        return float(2 * d * di + di * (cfg.dt_rank + 2 * cfg.mamba_d_state)
                     + cfg.dt_rank * di + di * d)
    # mlstm / slstm: projection up + gates + projection down
    pf = cfg.xlstm_proj_factor
    return float(3 * d * d * pf)


def _ffn_params(cfg: ModelConfig, i: int, *, active: bool) -> float:
    """Parameter bytes-relevant count of layer ``i``'s ffn/moe stage.

    ``active=True`` counts only routed-active experts (the decode-time
    weight stream); ``active=False`` counts the full expert bank (the
    prefill case, where a long chunk touches every expert)."""
    d = cfg.d_model
    if cfg.is_moe_layer(i) and cfg.n_experts:
        per_expert = 3.0 * d * cfg.moe_d_ff
        n_live = (cfg.top_k + cfg.n_shared_experts if active
                  else cfg.n_experts + cfg.n_shared_experts)
        return float(n_live * per_expert + d * cfg.n_experts)
    if cfg.d_ff <= 0:
        return 0.0
    mult = 3.0 if cfg.act == "swiglu" else 2.0
    return float(mult * d * cfg.d_ff)


def estimate_n_params(cfg: ModelConfig) -> float:
    """Analytic parameter-count estimate (embeddings + all layers,
    full expert banks).  Used to normalise per-layer shares when the
    caller supplies a measured ``n_params``."""
    total = float(cfg.vocab * cfg.d_model)
    if not cfg.tie_embeddings:
        total += cfg.vocab * cfg.d_model
    for i in range(cfg.n_layers):
        total += _mixer_params(cfg, i)
        total += _ffn_params(cfg, i, active=False)
    return total


def arch_kv_bytes_per_token(cfg: ModelConfig) -> float:
    """Total KV-cache bytes per token across all attention layers
    (bf16), mirroring ``ServingEngine._kv_bytes_per_token``."""
    n_attn = sum(1 for i in range(cfg.n_layers)
                 if cfg.layer_kind(i) == "attn")
    if cfg.attn_type == "mla":
        per = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    else:
        per = 2 * cfg.n_kv_heads * cfg.head_dim
    return float(n_attn * per * 2)


@dataclass
class TracedWorkload:
    """A traced serving snapshot: per-layer work items, the precedence
    graph over their profiles (``graph.kernels[i] is items[i].profile()``
    output, same order), and which request each item belongs to."""

    items: list[TpuWorkItem]
    graph: KernelGraph
    owners: list[int]          # item index -> request index
    tail_of: list[int]         # request index -> index of its last item


#: default traced snapshot: a continuous-batching queue where two
#: prompts are mid-prefill while six earlier requests decode at
#: spread-out kv lengths — prefill compute and decode memory coexist.
_DEFAULT_REQUESTS = (("prefill", 512), ("prefill", 256),
                     ("decode", 512), ("decode", 1024), ("decode", 2048),
                     ("decode", 3072), ("decode", 4096), ("decode", 6144))


def trace_arch(cfg: ModelConfig,
               requests: Iterable[tuple[str, int]] | None = None,
               *,
               n_params: float | None = None,
               kv_bytes_per_token: float | None = None,
               max_stages: int | None = None) -> TracedWorkload:
    """Trace a model config into per-layer work-item chains.

    Each request ``("prefill", seq_len)`` / ``("decode", kv_len)``
    expands into the chain of stages its forward pass runs — layer 0
    mixer, layer 0 ffn, layer 1 mixer, ... — with one
    :class:`~repro_torch.core.tpu.TpuWorkItem` per stage carrying that
    stage's parameter share (MoE ffn stages stream only routed-active
    experts on decode) and, for attention mixers, the layer's slice of
    the KV traffic.  Intra-request edges chain consecutive stages;
    cross-request items stay independent — exactly the structure the
    serving engine's per-request items flatten away.

    ``max_stages`` coarsens deep models by grouping consecutive stages
    into at most that many segments per request (shares and traffic
    sum), keeping graph sizes schedulable for 40-60 layer configs.
    """
    reqs = list(requests if requests is not None else _DEFAULT_REQUESTS)
    kvb_total = (kv_bytes_per_token if kv_bytes_per_token is not None
                 else arch_kv_bytes_per_token(cfg))
    n_attn = max(1, sum(1 for i in range(cfg.n_layers)
                        if cfg.layer_kind(i) == "attn"))
    kvb_layer = kvb_total / n_attn
    est = estimate_n_params(cfg)
    scale = (n_params / est) if n_params else 1.0

    items: list[TpuWorkItem] = []
    owners: list[int] = []
    tail_of: list[int] = []
    edges: set[tuple[int, int]] = set()
    for rid, (kind, length) in enumerate(reqs):
        if kind not in ("prefill", "decode"):
            raise ValueError(f"unknown request kind {kind!r}")
        # stage list: (label, param_share, kv_bytes_per_token)
        stages: list[tuple[str, float, float]] = []
        for i in range(cfg.n_layers):
            lk = cfg.layer_kind(i)
            stages.append((f"L{i}:{lk}", scale * _mixer_params(cfg, i),
                           kvb_layer if lk == "attn" else 0.0))
            ffn = _ffn_params(cfg, i, active=(kind == "decode"))
            if ffn > 0.0:
                lbl = "moe" if cfg.is_moe_layer(i) else "mlp"
                stages.append((f"L{i}:{lbl}", scale * ffn, 0.0))
        if max_stages is not None and len(stages) > max_stages:
            per = -(-len(stages) // max_stages)  # ceil
            grouped = []
            for s in range(0, len(stages), per):
                seg = stages[s:s + per]
                grouped.append((f"{seg[0][0]}..{seg[-1][0].split(':')[0]}",
                                sum(p for _, p, _ in seg),
                                sum(b for _, _, b in seg)))
            stages = grouped
        prev = None
        for label, share, kvb in stages:
            name = f"r{rid}:{kind[0]}:{label}"
            if kind == "prefill":
                it = prefill_profile(name, n_params=share, seq_len=length,
                                     kv_bytes_per_token=kvb)
            else:
                it = decode_profile(name, n_params=share, kv_len=length,
                                    kv_bytes_per_token=kvb)
            it = replace(it, weight_bytes=2.0 * share)  # bf16 stream
            idx = len(items)
            items.append(it)
            owners.append(rid)
            if prev is not None:
                edges.add((prev, idx))
            prev = idx
        tail_of.append(len(items) - 1)
    graph = KernelGraph([it.profile() for it in items], edges)
    return TracedWorkload(items=items, graph=graph, owners=owners,
                          tail_of=tail_of)
