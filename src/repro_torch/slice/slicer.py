"""Kernelet-style kernel slicing: cut oversized stages into
co-schedulable pieces.

The paper's reordering wins come from packing kernels whose resource
profiles are complementary; a stage whose profile saturates the device
(a prefill full-bank attention, a dense MoE up-projection) can never
share a round, so reordering alone leaves it serialized.  Kernelet
(Zhong & He) solves exactly this by slicing a large kernel's grid into
sub-grids that *can* co-execute with other kernels.  This module is
the slicing primitive the slice-aware scheduler
(:mod:`repro_torch.slice.constrained`) applies lazily — a stage is only cut
when the greedy's score vector shows it cannot pack with any frontier
peer:

* :class:`SlicePolicy` — how aggressively to cut: ``occupancy``
  (slice only stages that cannot fit a unit at all, to pieces under an
  occupancy threshold), ``round_fill`` (slice anything above a target
  round-fill fraction down to it), or ``fixed`` (cut triggered stages
  into a fixed number of pieces).  Granularity is a *scheduling
  decision* computed per stage from its profile (the ACS motivation:
  irregular, input-dependent graphs want per-stage choices, not a
  static config).
* :class:`KernelSlicer` — applies a policy to one
  :class:`~repro_torch.core.resources.KernelProfile` or
  :class:`~repro_torch.core.tpu.TpuWorkItem` with **exact accounting**:
  slice profiles sum back to the parent (work, traffic, demand mass
  and tokens are partitioned; block-parallel kernels partition the
  grid), while ``weight_bytes`` is *copied* to every slice — the
  parameter stream is a property of the stage, shared by its slices,
  and the serving round accounting
  (:meth:`repro_torch.serve.engine.ServingEngine._dag_round_time`) charges
  it once per distinct parent stage per round, never per slice.
* :func:`join_profile` / :func:`join_item` — the synthetic
  zero-work join node the graph expansion hangs the parent's
  out-edges off (:func:`repro_torch.slice.graph.expand_nodes`), so slices of
  one kernel stay mutually independent and downstream consumers wait
  for *all* of them.

Naming: a slice of ``r0:p:L3:moe`` is ``r0:p:L3:moe#s1of4``; its join
is ``r0:p:L3:moe#join``.  Everything after ``#`` is slice metadata —
:func:`parent_name` strips it, which is how per-stage weight
accounting keys slices back to their stage.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Sequence

from ..core.resources import DeviceModel, KernelProfile
from ..core.tpu import TpuWorkItem

__all__ = ["SlicePolicy", "KernelSlicer", "join_profile", "join_item",
           "parent_name", "is_slice", "is_join", "merge_slice_profiles",
           "slice_indices"]


def parent_name(name: str) -> str:
    """Strip slice metadata: ``r0:p:L3:moe#s1of4`` -> ``r0:p:L3:moe``."""
    return name.split("#", 1)[0]


def is_slice(name: str) -> bool:
    return "#s" in name


def is_join(name: str) -> bool:
    return name.endswith("#join")


@dataclass(frozen=True)
class SlicePolicy:
    """When to slice a stage and into how many pieces.

    ``mode``:

    * ``"occupancy"`` (default) — slice only stages that cannot fit an
      execution unit at all (solo footprint above ``trigger_frac`` of
      some capacity, default 1.0), into pieces each at most
      ``occupancy_threshold`` of the binding capacity:
      ``k = ceil(max_frac / occupancy_threshold)``.
    * ``"round_fill"`` — slice any stage whose footprint exceeds
      ``target_fill`` of a capacity down to pieces of at most that
      fill: ``k = ceil(max_frac / target_fill)``.  More aggressive:
      also cuts stages that fit but monopolise a round.
    * ``"fixed"`` — cut every triggered stage (footprint above
      ``trigger_frac``) into exactly ``fixed_k`` pieces.

    ``max_slices`` bounds k for any single stage; slicing functions
    additionally clamp k to the stage's own granularity (grid size for
    block-parallel kernels, token count for serving items) — a
    1-token decode step is never cut.  Slices are terminal: a slice or
    join is never re-sliced.
    """

    mode: str = "occupancy"
    occupancy_threshold: float = 0.75
    target_fill: float = 0.5
    fixed_k: int = 2
    trigger_frac: float = 1.0
    max_slices: int = 16

    def __post_init__(self):
        if self.mode not in ("occupancy", "round_fill", "fixed"):
            raise ValueError(f"unknown slice mode {self.mode!r}")
        if not (0.0 < self.occupancy_threshold <= 1.0):
            raise ValueError("occupancy_threshold must be in (0, 1]")
        if not (0.0 < self.target_fill <= 1.0):
            raise ValueError("target_fill must be in (0, 1]")
        if self.fixed_k < 1 or self.max_slices < 1:
            raise ValueError("fixed_k and max_slices must be >= 1")


def _balanced_split(total: int, k: int) -> list[int]:
    """``total`` into ``k`` positive integers differing by at most 1,
    largest parts first (deterministic)."""
    base, rem = divmod(total, k)
    return [base + (1 if i < rem else 0) for i in range(k)]


@dataclass
class KernelSlicer:
    """Applies a :class:`SlicePolicy` to kernels against one device."""

    policy: SlicePolicy
    device: DeviceModel

    # -- policy: how many pieces -----------------------------------------
    def footprint_frac(self, prof: KernelProfile) -> float:
        """Solo footprint of ``prof`` as a fraction of the tightest
        per-unit capacity (including the resident-block cap) — > 1.0
        means the stage cannot fit an execution unit at all."""
        dev = self.device
        d = prof.per_unit_demand(dev)
        frac = prof.blocks_per_unit(dev) / max(dev.max_resident, 1)
        for dim in dev.caps:
            cap = dev.cap(dim)
            if cap > 0:
                frac = max(frac, d.get(dim, 0.0) / cap)
        return frac

    def slice_count(self, prof: KernelProfile) -> int:
        """Slices the policy wants for ``prof``; 1 means don't slice.
        Slice granularity is a per-stage scheduling decision read off
        the profile, not a static config."""
        if "#" in prof.name:      # slices and joins are terminal
            return 1
        pol = self.policy
        frac = self.footprint_frac(prof)
        if pol.mode == "round_fill":
            if frac <= pol.target_fill:
                return 1
            k = -(-frac // pol.target_fill)           # ceil
        elif pol.mode == "occupancy":
            if frac <= pol.trigger_frac:
                return 1
            k = -(-frac // pol.occupancy_threshold)   # ceil
        else:                                         # fixed
            if frac <= pol.trigger_frac:
                return 1
            k = pol.fixed_k
        k = int(min(k, pol.max_slices))
        k = min(k, self._granularity(prof))
        return max(k, 1)

    def _granularity(self, prof: KernelProfile) -> int:
        """Finest legal cut: block-parallel kernels cut along the
        grid; single-block (serving) profiles cut along the
        parallel-slack dimension (token slots)."""
        if prof.n_blocks > 1:
            return int(prof.n_blocks)
        sd = self.device.sat_dim
        if sd and sd in prof.demands:
            return max(int(prof.demands[sd]), 1)
        return 1

    # -- mechanics: exact accounting -------------------------------------
    def slice_profile(self, prof: KernelProfile,
                      k: int | None = None) -> list[KernelProfile]:
        """Cut ``prof`` into ``k`` slice profiles whose resource totals
        sum back to the parent exactly.

        Block-parallel kernels (``n_blocks > 1``) partition the grid —
        per-block demands, work and intensity are unchanged, block
        counts sum to the parent's (Kernelet's sub-grid slicing).
        Single-block profiles partition *mass*: demands and per-block
        work scale by the slice's share, intensity is preserved.
        """
        k = self.slice_count(prof) if k is None else int(k)
        k = min(k, self._granularity(prof))
        if k <= 1:
            return [prof]
        if prof.n_blocks > 1:
            return [
                replace(prof, name=f"{prof.name}#s{i}of{k}", n_blocks=nb)
                for i, nb in enumerate(_balanced_split(int(prof.n_blocks), k))
            ]
        total = self._granularity(prof)
        shares = [p / total for p in _balanced_split(total, k)]
        return [
            KernelProfile(
                name=f"{prof.name}#s{i}of{k}",
                n_blocks=prof.n_blocks,
                demands={d: v * w for d, v in prof.demands.items()},
                inst_per_block=prof.inst_per_block * w,
                r=prof.r,
                agg_blocks_per_unit=prof.agg_blocks_per_unit,
            )
            for i, w in enumerate(shares)
        ]

    def slice_item(self, item: TpuWorkItem,
                   k: int | None = None) -> list[TpuWorkItem]:
        """Cut a serving work item along its token dimension into
        ``k`` slices with exact accounting: FLOPs, marginal HBM
        traffic, on-chip residency and tokens are partitioned
        proportionally (tokens as balanced integers) and sum back to
        the parent; arithmetic intensity is inherited; the shared
        parameter stream (``weight_bytes``) is *copied*, not split —
        it belongs to the stage and is charged once per round that
        touches any slice of it."""
        k = self.slice_count(item.profile()) if k is None else int(k)
        k = min(k, max(int(item.tokens), 1))
        if k <= 1:
            return [item]
        toks = _balanced_split(int(item.tokens), k)
        out = []
        for i, t in enumerate(toks):
            w = t / item.tokens
            out.append(TpuWorkItem(
                name=f"{item.name}#s{i}of{k}",
                flops=item.flops * w,
                hbm_bytes=item.hbm_bytes * w,
                vmem_bytes=item.vmem_bytes * w,
                tokens=t,
                intensity_hint=item.intensity,
                weight_bytes=item.weight_bytes,
            ))
        return out


def slice_indices(name: str) -> tuple[list[int], int]:
    """Parse slice metadata: ``r0:moe#s1of4 -> ([1], 4)``;
    merged slices carry every constituent index:
    ``r0:moe#s1+3of4 -> ([1, 3], 4)``."""
    if "#s" not in name:
        raise ValueError(f"{name!r} is not a slice name")
    meta = name.rsplit("#s", 1)[1]
    idx_part, k_part = meta.rsplit("of", 1)
    return sorted(int(p) for p in idx_part.split("+")), int(k_part)


def merge_slice_profiles(slices: Sequence[KernelProfile],
                         block_parallel: bool | None = None
                         ) -> KernelProfile:
    """Inverse of :meth:`KernelSlicer.slice_profile` for sibling
    slices: one profile whose resource totals are the exact sum of the
    inputs' (the same conservation law slicing obeys, run backwards).

    Block-parallel siblings merge by summing grid blocks (per-block
    demands, work and intensity unchanged); mass-sliced siblings
    (single-block serving profiles) merge by summing demands and
    per-block work, preserving intensity.  ``block_parallel=None``
    infers the mode: any multi-block slice, or identical per-block
    demand/work vectors across all siblings, means grid slicing (mass
    shares are balanced integers, so equal mass shares — the one
    ambiguous corner — merge block-shaped; totals are conserved under
    either reading).

    Merging *every* sibling (indices cover ``0..k-1``) restores the
    parent name; a partial merge keeps slice metadata, e.g.
    ``moe#s1of4 + moe#s3of4 -> moe#s1+3of4``, so
    :func:`is_slice` / :func:`parent_name` keep working and a later
    pass can finish the merge.
    """
    if not slices:
        raise ValueError("need >= 1 slice to merge")
    if len(slices) == 1:
        return slices[0]
    parent = parent_name(slices[0].name)
    idxs: list[int] = []
    k_tot = None
    for s in slices:
        if parent_name(s.name) != parent:
            raise ValueError(f"not siblings: {s.name!r} vs {parent!r}")
        ix, k = slice_indices(s.name)
        if k_tot is None:
            k_tot = k
        elif k != k_tot:
            raise ValueError(f"slice counts disagree on {s.name!r}")
        idxs.extend(ix)
    if len(set(idxs)) != len(idxs):
        raise ValueError("duplicate slice indices")
    idxs.sort()
    full = idxs == list(range(k_tot))
    name = (parent if full else
            f"{parent}#s{'+'.join(str(i) for i in idxs)}of{k_tot}")
    first = slices[0]
    if block_parallel is None:
        same = all(
            s.demands == first.demands and
            s.inst_per_block == first.inst_per_block and
            s.r == first.r for s in slices[1:])
        block_parallel = any(s.n_blocks > 1 for s in slices) or same
    if block_parallel:
        return replace(first, name=name,
                       n_blocks=sum(int(s.n_blocks) for s in slices))
    dims = {d for s in slices for d in s.demands}
    return KernelProfile(
        name=name,
        n_blocks=first.n_blocks,
        demands={d: sum(s.demands.get(d, 0.0) for s in slices)
                 for d in dims},
        inst_per_block=sum(s.inst_per_block for s in slices),
        r=first.r,
        agg_blocks_per_unit=first.agg_blocks_per_unit,
    )


def join_profile(parent: KernelProfile) -> KernelProfile:
    """The synthetic join node for ``parent``'s slices: zero work,
    zero demands, one block — a pure synchronisation marker.  The
    graph expansion hangs the parent's out-edges off it so successors
    wait for *every* slice; the gated simulator
    (:class:`repro_torch.graph.streams.DagEventSimulator`) retires zero-work
    kernels instantly once their predecessors drain, so a join never
    occupies a unit or adds modelled time."""
    return KernelProfile(
        name=f"{parent_name(parent.name)}#join",
        n_blocks=1,
        demands={d: 0.0 for d in parent.demands},
        inst_per_block=0.0,
        r=1.0,
    )


def join_item(parent: TpuWorkItem) -> TpuWorkItem:
    """Serving-item twin of :func:`join_profile` (zero cost, zero
    tokens, unit intensity so ``mem_per_block`` stays defined)."""
    return TpuWorkItem(
        name=f"{parent_name(parent.name)}#join",
        flops=0.0, hbm_bytes=0.0, vmem_bytes=0.0, tokens=0,
        intensity_hint=1.0, weight_bytes=0.0,
    )
