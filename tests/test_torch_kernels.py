"""The port's RMSNorm, decode-attention, flash-attention, event-scan and
selective-scan kernels.

On the CPU the wrappers run their plain versions, checked here against
the reference's Pallas kernels (interpret mode) and pure-jnp oracles at
the reference's tolerances (``tests/test_kernels.py``: f32 2e-5, bf16
2e-2); the event scan's plain version against the reference's scans
and both packages' float64 oracles within ``F32_EVENT_RTOL`` (relative).
Tests marked ``cuda`` hold the CUDA kernels against their plain
versions on the card at the shapes of the serving and forward paths; they skip where
no CUDA device is present (``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_*.py`` on the card).
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core.seeded import scan_table
from repro_torch.kernels import (decode_attention, decode_attention_plain,
                                 decode_plan, event_scan, event_times, event_times_plain,
                                 event_times_reference, flash_attention,
                                 flash_attention_plain, flash_plan,
                                 launch_counts,
                                 mamba_scan, mamba_scan_plain, ops,
                                 reset_launch_counts, rmsnorm_plan,
                                 rmsnorm_rows, rmsnorm_rows_plain, scan_plan)
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels.mamba_scan import _plan as _scan_plan_of
from torch_threads import one_torch_thread  # noqa: F401

_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def _no_mesh():
    """A mesh left bound by another test on this worker must not reach
    the reference kernels' jitted wrappers."""
    try:
        from repro.dist.context import set_activation_axes
    except ImportError:   # no JAX here, so no reference either
        yield
        return
    set_activation_axes()
    yield


@pytest.fixture
def ref():
    """The JAX reference (its Pallas kernels and oracles).  Imported
    here, not at the top, so that the card-only tests below also run
    where JAX is not installed."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops, ref
    return SimpleNamespace(jnp=jnp, ops=ops, ref=ref)


@pytest.fixture
def cuda():
    """The CUDA device, or a skip where there is none (decided here, at
    run time, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _both(jnp, a: np.ndarray, dtype: str):
    """The same values in both frameworks (f32 -> bf16 rounds to nearest
    even in both)."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _close(out, expect, dtype):
    tol = _TOL[dtype]
    np.testing.assert_allclose(
        out.float().numpy() if isinstance(out, torch.Tensor)
        else np.asarray(out, np.float32),
        np.asarray(expect, np.float32), rtol=tol, atol=tol)


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("R,D", [(64, 256), (256, 1024), (100, 512),
                                 (1, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_reference(ref, R, D, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((R, D)).astype(np.float32)
    s = (rng.standard_normal(D) * 0.1 + 1.0).astype(np.float32)
    jx, tx = _both(ref.jnp, x, dtype)
    js = ref.jnp.asarray(s)
    out = ops.rmsnorm(tx, torch.from_numpy(s))
    assert out.dtype == tx.dtype and out.shape == tx.shape
    _close(out, ref.ops.rmsnorm(jx, js, interpret=True), dtype)
    _close(out, ref.ref.rmsnorm_ref(jx, js), dtype)


#: the widths the ten configs normalise with RMSNorm: deepseek-v2's
#: kv_norm 512 and q_norm 1536, xlstm-125m's 768, qwen's 1024, jamba's and
#: mixtral's 4096, deepseek-v2's, mistral-nemo's and pixtral's 5120,
#: internlm2's 6144
_RMS_WIDTHS = [512, 768, 1024, 1536, 4096, 5120, 6144]
_H100_SMS = 132


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows", [1, 8, 4096, 32768])
@pytest.mark.parametrize("D", _RMS_WIDTHS)
def test_rmsnorm_plan_covers_every_row_once(D, rows, dtype):
    """The plan's launch, walked as the kernel walks it: every row taken
    by exactly one group of lanes (one warp, or whole warps that are the
    block) of one block; the group's lanes hold every 16-byte vector of
    the row once, 4 at most, within the register budget; one warp a row
    at bf16's 512 and 768, two warps at 1024 and 1536; one block for each
    block's rows."""
    dt = getattr(torch, dtype)
    plan = rmsnorm_plan(rows, D, dt, _H100_SMS)
    assert plan == rmsnorm_plan(rows, D, dt, _H100_SMS)
    nv = D // (8 if dt == torch.bfloat16 else 4)
    G, L = plan.rows_per_block, plan.lanes
    assert plan.threads == G * L and plan.threads % 32 == 0
    assert plan.threads <= 256
    if L <= 32:
        assert 32 % L == 0        # a row's lanes inside one warp
    else:
        assert L % 32 == 0 and G == 1   # whole warps; the block is the row
    if dt == torch.bfloat16:
        assert L == {512: 32, 768: 32, 1024: 64, 1536: 64}.get(D, L)
        assert plan.vecs <= 4
    # every vector of a row on one lane, once: j = lane + k * lanes
    j = (np.arange(L)[:, None] + np.arange(plan.vecs)[None, :] * L).ravel()
    assert np.array_equal(np.sort(j[j < nv]), np.arange(nv))
    assert (plan.vecs - 1) * L < nv
    # registers a lane's loads fill (4 a raw vector, V for its f32 scale),
    # and 16 to spare, within what csrc/rmsnorm.cu's __launch_bounds__
    # leaves a thread: 3 blocks of 256 an SM up to 4 vectors, else 2
    blocks = 3 if plan.vecs <= 4 else 2
    V = 16 // dt.itemsize
    assert plan.vecs * (4 + V) + 16 <= 65536 // (256 * blocks)
    # the rows: block b, group g -> b * G + g
    assert plan.grid == -(-rows // G)
    b, g = np.meshgrid(np.arange(plan.grid), np.arange(G), indexing="ij")
    r = (b * G + g).ravel()
    assert np.array_equal(np.sort(r[r < rows]), np.arange(rows))
    # blocks of narrow rows enough for every SM, where the rows allow
    assert plan.grid >= min(rows, _H100_SMS) or G == 4 * max(1, 32 // L)


@pytest.mark.parametrize("D,dtype,exc", [
    (0, torch.bfloat16, ValueError), (4, torch.float32, ValueError),
    (12, torch.bfloat16, ValueError), (8200, torch.bfloat16, ValueError),
    (16384, torch.float32, ValueError), (1024, torch.float16, TypeError),
    (1024, torch.float64, TypeError)])
def test_rmsnorm_plan_refuses_what_the_contract_refuses(D, dtype, exc):
    with pytest.raises(exc):
        rmsnorm_plan(16, D, dtype, _H100_SMS)


def test_rmsnorm_plan_refuses_no_rows():
    with pytest.raises(ValueError):
        rmsnorm_plan(0, 1024, torch.bfloat16, _H100_SMS)


def test_rmsnorm_plan_every_width_the_contract_takes():
    """Every D the contract takes (multiples of 8 up to 8192) has a plan
    the C entry point accepts: lanes a power of two up to 32 or whole
    warps up to 8, at most 8 vectors a lane (4 in bf16) covering the
    row."""
    for dt in (torch.bfloat16, torch.float32):
        for D in range(8, 8193, 8):
            p = rmsnorm_plan(3, D, dt, _H100_SMS)
            nv = D // (8 if dt == torch.bfloat16 else 4)
            assert (p.lanes <= 32 and p.lanes & (p.lanes - 1) == 0) or (
                p.lanes % 32 == 0 and p.lanes <= 256)
            assert 1 <= p.vecs <= (4 if dt == torch.bfloat16 else 8)
            assert p.vecs * p.lanes >= nv


def test_ops_rmsnorm_takes_any_leading_shape_on_the_cpu():
    """``ops.rmsnorm`` is the wrapper module's ``rmsnorm``: on the CPU
    (plain version) x (..., D), contiguous or not, gives the bits of
    ``rmsnorm_rows`` on its rows."""
    assert ops.rmsnorm is RN.rmsnorm
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 64, generator=g).to(torch.bfloat16)
    s = torch.randn(64, generator=g) * 0.1 + 1.0
    for xi in (x, x.transpose(0, 1), x[:, :, :64], x[0]):
        want = rmsnorm_rows(xi.reshape(-1, 64), s).reshape(xi.shape)
        assert torch.equal(ops.rmsnorm(xi, s), want)


# --------------------------------------------------------------------------
# Decode attention
# --------------------------------------------------------------------------

def _attn_inputs(B, H, Hkv, T, D, lengths, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


def _reference(ref, q, k, v, lengths, dtype, kv_dtype):
    """The reference's Pallas kernel (interpret mode) and its oracle on
    the same inputs; the oracle takes one dtype, so it gets the cache's
    values at q's dtype."""
    jnp = ref.jnp
    jq = jnp.asarray(q, getattr(jnp, dtype))
    jk = jnp.asarray(k, getattr(jnp, kv_dtype))
    jv = jnp.asarray(v, getattr(jnp, kv_dtype))
    kernel = ref.ops.decode_attention(jq, jk, jv, jnp.asarray(lengths),
                                      interpret=True)
    B, H, D = q.shape
    _, T, Hkv, _ = k.shape
    g = H // Hkv
    kf = jnp.repeat(jk, g, 2).transpose(0, 2, 1, 3).reshape(B * H, T, D)
    vf = jnp.repeat(jv, g, 2).transpose(0, 2, 1, 3).reshape(B * H, T, D)
    lens = jnp.repeat(jnp.asarray(lengths)[:, None], H, 1).reshape(B * H, 1)
    oracle = ref.ref.decode_attention_ref(
        jq.reshape(B * H, 1, D), kf.astype(jq.dtype), vf.astype(jq.dtype),
        lens, scale=1.0 / np.sqrt(D)).reshape(B, H, D)
    return kernel, oracle


@pytest.mark.parametrize("B,H,Hkv,T,D,lengths", [
    (2, 4, 2, 512, 64, [1, 300]),        # tests/test_kernels.py shapes
    (1, 2, 2, 1024, 128, [1024]),
    (3, 4, 1, 256, 80, [17, 255, 256]),
    (1, 6, 6, 32, 16, [5]),              # qwen smoke: g = 1, D = 16
    (2, 8, 2, 64, 16, [64, 33]),         # mistral smoke: g = 4
    (1, 16, 16, 128, 64, [1]),           # qwen full width, g = 1
    (2, 16, 4, 96, 128, [96, 50]),       # g = 4, D = 128
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_reference(ref, B, H, Hkv, T, D,
                                                  lengths, dtype):
    q, k, v, lens = _attn_inputs(B, H, Hkv, T, D, lengths)
    kernel, oracle = _reference(ref, q, k, v, lens, dtype, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    out = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _close(out, kernel, dtype)
    _close(out, oracle, dtype)


def test_decode_attention_plain_f32_query_bf16_cache(ref):
    """The f32 configs meet an f32 query with the default bf16 cache."""
    q, k, v, lens = _attn_inputs(2, 8, 2, 64, 16, [9, 64])
    kernel, _ = _reference(ref, q, k, v, lens, "float32", "bfloat16")
    out = ops.decode_attention(torch.from_numpy(q),
                               torch.from_numpy(k).bfloat16(),
                               torch.from_numpy(v).bfloat16(),
                               torch.from_numpy(lens))
    assert out.dtype == torch.float32
    _close(out, kernel, "float32")


def test_decode_attention_lengths_sweep(ref):
    """Every valid length from 1 to T against the oracle."""
    B, H, Hkv, T, D = 1, 4, 2, 40, 16
    for L in range(1, T + 1):
        q, k, v, lens = _attn_inputs(B, H, Hkv, T, D, [L], seed=L)
        _, oracle = _reference(ref, q, k, v, lens, "float32", "float32")
        out = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(lens))
        _close(out, oracle, "float32")


def test_decode_attention_reads_strided_cache():
    """A cache view (a slice of a longer one) gives the same result as
    its contiguous copy."""
    q, k, v, lens = _attn_inputs(1, 4, 2, 64, 16, [20])
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    a = decode_attention(torch.from_numpy(q), tk[:, :32], tv[:, :32],
                         torch.from_numpy(lens))
    b = decode_attention(torch.from_numpy(q), tk[:, :32].contiguous(),
                         tv[:, :32].contiguous(), torch.from_numpy(lens))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# The kernel's split-KV plan and walk, mirrored on the CPU: the plan's
# limits, the device-side split rule, and the split-and-combine arithmetic.

_SMEM_MAX = 232448   # 227 KB, a Hopper block's most


def _split(length, T, tile, S, rank):
    """The kernel's split rule: block ``rank`` of a cluster of S takes
    tiles rank, rank + S, ... of ``tile`` positions of the prefix
    [0, len), len clamped to [0, T], each cut at len."""
    n = min(max(length, 0), T)
    ntiles = -(-n // tile)
    mine = (ntiles - rank + S - 1) // S if ntiles > rank else 0
    return [(t * tile, min(t * tile + tile, n))
            for t in (rank + i * S for i in range(mine))]


@pytest.mark.parametrize("D", [8, 16, 64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_plan_fits_the_card(D, dtype):
    """Shared memory within a block's 227 KB, the grid whole clusters of
    S, one cluster per (batch, KV head, head group), for B * Hkv from 1
    to 64 and groups g from 1 to 12."""
    for B, Hkv in ((1, 1), (1, 8), (1, 16), (2, 16), (8, 8), (4, 16),
                   (64, 1)):
        for g in (1, 2, 3, 4, 6, 8, 12):
            for T in (1, 33, 512, 32768):
                plan = decode_plan(B, g * Hkv, Hkv, T, D, dtype, dtype)
                assert plan.smem <= _SMEM_MAX
                assert plan.grid % plan.cluster == 0
                assert plan.grid == B * Hkv * -(-g // plan.heads) * plan.cluster
                assert plan.heads in (1, 2, 4, 8) and plan.heads >= min(g, 8)
                assert plan.tile & (plan.tile - 1) == 0
                assert 8 <= plan.tile <= 256   # a TMA box has 256 rows at most
                assert plan.cluster == 8 and plan.stages >= 2


@pytest.mark.parametrize("T", [1, 31, 32, 33, 512, 4096])
@pytest.mark.parametrize("D,dtype", [(64, torch.bfloat16),
                                     (256, torch.float32)])
def test_decode_split_covers_prefix_once(T, D, dtype):
    """For every length (and one beyond each end), the S blocks' tiles
    cover every position of the clamped prefix exactly once."""
    plan = decode_plan(1, 16, 16, T, D, dtype, dtype)
    for length in range(-1, T + 2):
        n = min(max(length, 0), T)
        seen = np.zeros(T, np.int64)
        for r in range(plan.cluster):
            for a, b in _split(length, T, plan.tile, plan.cluster, r):
                assert 0 <= a < b <= n
                seen[a:b] += 1
        assert (seen[:n] == 1).all() and (seen[n:] == 0).all()


def _split_twin(q, k, v, lengths, tile, S):
    """The kernel's split-and-combine arithmetic in plain f32: each split's
    online-softmax partial (m, l, acc) in base 2, an empty split
    (m, l, acc) = (-1e30, 0, 0), merged in rank order 0..S-1; a row whose
    splits are all empty gets zeros."""
    B, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qs = q.float() * (math.log2(math.e) / math.sqrt(D))
    out = torch.zeros(B, H, D)
    for b in range(B):
        for h in range(H):
            parts = []
            for r in range(S):
                idx = [t for a, e in _split(int(lengths[b]), T, tile, S, r)
                       for t in range(a, e)]
                if not idx:
                    parts.append((-1e30, 0.0, torch.zeros(D)))
                    continue
                s = k[b, idx, h // g].float() @ qs[b, h]
                m = float(s.max())
                p = torch.exp2(s - m)
                parts.append((m, float(p.sum()), p @ v[b, idx, h // g].float()))
            M = max(m for m, _, _ in parts)
            L, A = 0.0, torch.zeros(D)
            for m, l, a in parts:
                w = 2.0 ** (m - M)
                L, A = L + l * w, A + a * w
            if L > 0:
                out[b, h] = A / L
    return out


@pytest.mark.parametrize("B,H,Hkv,T,D,lengths,tile,S", [
    (3, 4, 2, 64, 16, [0, 5, 64], 8, 8),      # length 0; 7 empty splits
    (3, 4, 2, 64, 16, [0, 5, 64], 8, 1),      # one split
    (2, 8, 2, 100, 32, [1, 77], 16, 3),       # g = 4, uneven deal
    (2, 6, 6, 256, 64, [255, 129], 32, 8),    # every split non-empty
    (1, 16, 4, 40, 16, [33], 8, 5),           # the last split partial
    (2, 6, 3, 96, 24, [0, 0], 8, 8),          # every row empty
])
def test_decode_split_twin_matches_reference(ref, B, H, Hkv, T, D, lengths,
                                             tile, S):
    """The split-and-combine arithmetic against the Pallas kernel
    (interpret mode) and the oracle, f32 2e-5, on the rows of non-zero
    length; rows of length 0 are exactly zero (the reference's kernel
    averages v there)."""
    q, k, v, lens = _attn_inputs(B, H, Hkv, T, D, lengths)
    out = _split_twin(*(torch.from_numpy(a) for a in (q, k, v)),
                      lens, tile, S)
    live = lens > 0
    assert (out[~live] == 0).all()
    if live.any():
        kernel, oracle = _reference(ref, q, k, v, lens, "float32", "float32")
        _close(out[live], np.asarray(kernel)[live], "float32")
        _close(out[live], np.asarray(oracle)[live], "float32")


def test_cpu_tensors_take_plain_versions_and_count_no_launch():
    reset_launch_counts()
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
    s = torch.ones(64)
    torch.testing.assert_close(rmsnorm_rows(x, s), rmsnorm_rows_plain(x, s),
                               rtol=0, atol=0)
    q, k, v, lens = (torch.from_numpy(a) for a in
                     _attn_inputs(1, 4, 2, 32, 16, [7]))
    torch.testing.assert_close(decode_attention(q, k, v, lens),
                               decode_attention_plain(q, k, v, lens),
                               rtol=0, atol=0)
    fq, fk, fv = (torch.from_numpy(a) for a in _flash_inputs(1, 40, 4, 2, 16))
    torch.testing.assert_close(flash_attention(fq, fk, fv),
                               flash_attention_plain(fq, fk, fv),
                               rtol=0, atol=0)
    table = scan_table("gpu8")
    rows = _scan_rows(table, 3)
    torch.testing.assert_close(event_times(rows, table),
                               event_times_plain(rows, table), rtol=0, atol=0)
    ms = [torch.from_numpy(a) for a in _scan_inputs(1, 9, 16, 4)]
    torch.testing.assert_close(mamba_scan(*ms), mamba_scan_plain(*ms),
                               rtol=0, atol=0)
    assert launch_counts() == {"rmsnorm": 0, "decode_attention": 0,
                               "flash_attention": 0, "event_scan": 0,
                               "mamba_scan": 0}


# --------------------------------------------------------------------------
# Flash attention
# --------------------------------------------------------------------------

def _flash_inputs(B, S, H, Hkv, D, T=None, seed=2):
    rng = np.random.default_rng(seed)
    T = S if T is None else T
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, T, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, T, Hkv, D)).astype(np.float32))


def _flash_oracle(ref, jq, jk, jv, causal, window):
    """``ref.flash_attention_ref`` in the reference's head-flattened
    layout, with the KV heads repeated as its ``ops`` wrapper does."""
    jnp = ref.jnp
    B, S, H, D = jq.shape
    T = jk.shape[1]

    def flat(x, n):
        return jnp.repeat(x, H // x.shape[2], 2).transpose(0, 2, 1, 3) \
            .reshape(B * H, n, D)
    out = ref.ref.flash_attention_ref(
        flat(jq, S), flat(jk, T), flat(jv, T), scale=1.0 / np.sqrt(D),
        causal=causal, window=window)
    return out.reshape(B, H, S, D).transpose(0, 2, 1, 3)


_FLASH_MASKS = [(True, None), (True, 96), (False, None)]


@pytest.mark.parametrize("B,S,H,Hkv,D", [
    (1, 128, 2, 2, 64),                  # tests/test_kernels.py shapes
    (2, 256, 4, 2, 128),
    (1, 512, 4, 1, 80),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", _FLASH_MASKS)
def test_flash_attention_plain_matches_reference(ref, B, S, H, Hkv, D, dtype,
                                                 causal, window):
    q, k, v = _flash_inputs(B, S, H, Hkv, D)
    (jq, tq), (jk, tk), (jv, tv) = (_both(ref.jnp, a, dtype)
                                    for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _close(out, ref.ops.flash_attention(jq, jk, jv, causal=causal,
                                        window=window, interpret=True), dtype)
    _close(out, _flash_oracle(ref, jq, jk, jv, causal, window), dtype)


@pytest.mark.parametrize("B,S,H,Hkv,D,T", [
    (1, 200, 4, 2, 64, 200),     # an S the Pallas kernel cannot take
    (2, 37, 9, 3, 16, 37),       # starcoder2 smoke grouping, g = 3
    (1, 61, 6, 1, 20, 61),       # Hkv = 1 and hubert smoke's D = 20
    (1, 50, 4, 4, 16, 80),       # S < T
])
@pytest.mark.parametrize("causal,window", _FLASH_MASKS)
def test_flash_attention_plain_odd_shapes_match_oracle(ref, B, S, H, Hkv, D,
                                                       T, causal, window):
    q, k, v = _flash_inputs(B, S, H, Hkv, D, T)
    (jq, tq), (jk, tk), (jv, tv) = (_both(ref.jnp, a, "float32")
                                    for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, window=window)
    _close(out, _flash_oracle(ref, jq, jk, jv, causal, window), "float32")


# --------------------------------------------------------------------------
# On the card: kernel vs plain version
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("D", [512, 1536, 5120])
def test_rmsnorm_kernel_at_deepseek_widths_on_card(cuda, D):
    """deepseek-v2's kv_norm (512), q_norm (1536) and d_model (5120)
    widths at a prefill's 4,096 rows, bf16; two calls give the same
    bits."""
    g = torch.Generator().manual_seed(D)
    x = torch.randn(4096, D, generator=g).to(cuda, torch.bfloat16)
    s = (torch.randn(D, generator=g) * 0.1 + 1.0).to(cuda)
    out = rmsnorm_rows(x, s)
    torch.cuda.synchronize()
    tol = _TOL["bfloat16"]
    torch.testing.assert_close(out.float(), rmsnorm_rows_plain(x, s).float(),
                               rtol=tol, atol=tol)
    assert torch.equal(out, rmsnorm_rows(x, s))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("R", [1, 8, 4096])
@pytest.mark.parametrize("D", _RMS_WIDTHS)
def test_rmsnorm_kernel_at_every_config_width_on_card(cuda, D, R, dtype):
    """Every width the configs normalise, at a decode step's 1 and 8 rows
    and a prefill's 4,096, against the plain version; one launch a call,
    the same bits on a second call, and ``ops.rmsnorm`` on the rows as
    (R, 1, D) (launched without a reshape) gives them too."""
    g = torch.Generator().manual_seed(D + R)
    dt = getattr(torch, dtype)
    x = torch.randn(R, D, generator=g).to(cuda, dt)
    s = (torch.randn(D, generator=g) * 0.1 + 1.0).to(cuda)
    before = rmsnorm_rows.launches
    out = rmsnorm_rows(x, s)
    torch.cuda.synchronize()
    assert rmsnorm_rows.launches == before + 1
    tol = _TOL[dtype]
    torch.testing.assert_close(out.float(), rmsnorm_rows_plain(x, s).float(),
                               rtol=tol, atol=tol)
    assert torch.equal(out, rmsnorm_rows(x, s))
    three = ops.rmsnorm(x.view(R, 1, D), s)
    assert three.shape == (R, 1, D) and torch.equal(three.view(R, D), out)


@pytest.mark.cuda
def test_rmsnorm_kernel_on_the_current_stream_on_card(cuda):
    """The kernel launches on the current stream: a side stream's call
    and a CUDA graph's replay give the default stream's bits; an x
    through ``ops.rmsnorm`` whose rows need a copy is normalised as
    that copy."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(4096, 1024, generator=g).to(cuda, torch.bfloat16)
    s = (torch.randn(1024, generator=g) * 0.1 + 1.0).to(cuda)
    want = rmsnorm_rows(x, s)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = rmsnorm_rows(x, s)
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(got, want)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = rmsnorm_rows(x, s)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, want)
    wide = torch.randn(64, 2, 1024, generator=g).to(cuda, torch.bfloat16)
    t = wide.transpose(0, 1)
    assert torch.equal(ops.rmsnorm(t, s).reshape(-1, 1024),
                       rmsnorm_rows(t.reshape(-1, 1024), s))


@pytest.mark.cuda
def test_rmsnorm_raises_on_inputs_it_does_not_take_on_card(cuda):
    """Every input the kernel does not take raises, before and after a
    launch for the same shape has been made (the call path keeps one
    per shape): x or scale off the card or elsewhere, a dtype other
    than f32/bf16 or a scale other than f32, shapes other than (R, D)
    and (D,), D not a multiple of 8 up to 8192, non-contiguous or
    unaligned inputs; none of them launches."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(16, 1024, generator=g).to(cuda, torch.bfloat16)
    s = torch.ones(1024, device=cuda)
    flat = torch.randn(16 * 1024 + 8, generator=g).to(cuda, torch.bfloat16)
    bad = [
        (ValueError, x, s.cpu()),
        (TypeError, x.half(), s),
        (TypeError, x, s.double()),
        (TypeError, x, s.to(torch.bfloat16)),
        (ValueError, x.view(16, 1, 1024), s),
        (ValueError, x, s[:512]),
        (ValueError, x, torch.ones(1, 1024, device=cuda)),
        (ValueError, x[:, :1020], s[:1020]),
        (ValueError, torch.zeros(4, 8200, device=cuda), torch.ones(
            8200, device=cuda)),
        (ValueError, x.t().contiguous().t(), s),
        (ValueError, x, torch.ones(2048, device=cuda)[::2]),
        (ValueError, flat[1:1 + 16 * 1024].view(16, 1024), s),
        (ValueError, x, torch.ones(1025, device=cuda)[1:]),
    ]
    for warm in (False, True):
        if warm:
            rmsnorm_rows(x, s)
            rmsnorm_rows(torch.zeros(4, 8200, device=cuda)[:, :8192]
                         .contiguous(), torch.ones(8192, device=cuda))
        before = rmsnorm_rows.launches
        for exc, xi, si in bad:
            with pytest.raises(exc):
                rmsnorm_rows(xi, si)
        assert rmsnorm_rows.launches == before
    with pytest.raises(ValueError):
        ops.rmsnorm(x.view(4, 4, 1024), s.cpu())
    assert torch.equal(rmsnorm_rows(x[:0], s), x[:0])


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain_on_card(cuda, R, dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(R, 1024, generator=g).to(cuda, getattr(torch, dtype))
    s = (torch.randn(1024, generator=g) * 0.1 + 1.0).to(cuda)
    before = rmsnorm_rows.launches
    out = rmsnorm_rows(x, s)
    torch.cuda.synchronize()
    assert rmsnorm_rows.launches == before + 1
    tol = _TOL[dtype]
    torch.testing.assert_close(out.float(), rmsnorm_rows_plain(x, s).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("R,D", [(8192, 1024), (64, 768)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_autograd_matches_plain_on_card(cuda, R, D, dtype):
    """F5: under grad the kernel runs inside an ``autograd.Function``
    (one launch), and its output, dx and dscale (the plain f32 backward)
    agree with autograd through the plain version, at the training
    path's 8,192 rows and xlstm's width."""
    g = torch.Generator().manual_seed(R)
    dt = getattr(torch, dtype)
    x0 = torch.randn(R, D, generator=g).to(cuda, dt)
    s0 = (torch.randn(D, generator=g) * 0.1 + 1.0).to(cuda)
    gy = torch.randn(R, D, generator=g).to(cuda, dt)
    x, s = x0.clone().requires_grad_(), s0.clone().requires_grad_()
    before = rmsnorm_rows.launches
    y = rmsnorm_rows(x, s)
    assert rmsnorm_rows.launches == before + 1 and y.grad_fn is not None
    dx, ds = torch.autograd.grad(y, (x, s), gy)
    xp, sp = x0.clone().requires_grad_(), s0.clone().requires_grad_()
    yp = rmsnorm_rows_plain(xp, sp)
    dxp, dsp = torch.autograd.grad(yp, (xp, sp), gy)
    torch.cuda.synchronize()
    tol = _TOL[dtype]
    for a, b in ((y, yp), (dx, dxp), (ds, dsp)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a.detach().float(), b.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
def test_kernels_without_backward_raise_under_grad_on_card(cuda):
    """F5: flash attention, decode attention and the selective scan have
    no backward: where autograd would record they raise, and under
    ``no_grad`` the same calls launch."""
    g = torch.Generator().manual_seed(1)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g).to(cuda, dtype)
    q, kv = rnd(1, 64, 4, 64), rnd(1, 64, 4, 64)
    qd = rnd(1, 4, 64)
    lens = torch.full((1,), 64, dtype=torch.int32, device=cuda)
    x, dt = rnd(1, 16, 64, dtype=torch.float32), \
        rnd(1, 16, 64, dtype=torch.float32).abs() * 0.1
    bm, cm = rnd(1, 16, 16, dtype=torch.float32), \
        rnd(1, 16, 16, dtype=torch.float32)
    a, d = -rnd(64, 16, dtype=torch.float32).abs(), rnd(64,
                                                         dtype=torch.float32)
    calls = {"flash_attention": lambda q: flash_attention(q, kv, kv),
             "decode_attention": lambda q: decode_attention(q, kv, kv, lens),
             "mamba_scan": lambda q: mamba_scan(q, dt, bm, cm, a, d)}
    firsts = {"flash_attention": q, "decode_attention": qd, "mamba_scan": x}
    for name, call in calls.items():
        leaf = firsts[name].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            call(leaf)
        with torch.no_grad():
            out = call(leaf)
        assert out.grad_fn is None
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,T,D,lengths", [
    (1, 16, 16, 512, 64, [1]),
    (1, 16, 16, 512, 64, [100]),
    (1, 16, 16, 512, 64, [511]),
    (1, 16, 16, 512, 64, [512]),
    (4, 32, 8, 4096, 128, [1, 1000, 4095, 4096]),
    # long caches: qwen's heads at the full 32,768-position context
    (1, 16, 16, 32768, 64, [32768]),
    (1, 16, 16, 32768, 64, [4097]),
    # both sides of every tile (32 or 64 positions at D 64) and of the
    # deal of tiles over a cluster of 8 (8 tiles: 256 or 512 positions)
    (12, 16, 16, 1024, 64, [31, 32, 33, 63, 64, 65, 255, 256, 257, 511,
                            512, 513]),
    # rows of length 0 (every split empty) beside full ones, g = 4
    (3, 32, 8, 4096, 128, [0, 4096, 1]),
    (2, 6, 6, 64, 16, [0, 0]),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_kernel_matches_plain_on_card(cuda, B, H, Hkv, T, D,
                                                       lengths, dtype):
    """Within tolerance of the plain version (rows of length 0 exactly
    zero, where the plain version averages v), and the same bits on a
    second call."""
    q, k, v, lens = _attn_inputs(B, H, Hkv, T, D, lengths)
    dt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(cuda, dt) for a in (q, k, v))
    tl = torch.from_numpy(lens).to(cuda)
    before = decode_attention.launches
    out = decode_attention(tq, tk, tv, tl)
    again = decode_attention(tq, tk, tv, tl)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    assert torch.equal(out, again)
    live = torch.from_numpy(lens > 0).to(cuda)
    assert (out[~live] == 0).all()
    tol = _TOL[dtype]
    torch.testing.assert_close(
        out[live].float(),
        decode_attention_plain(tq, tk, tv, tl)[live].float(),
        rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,T,D,lengths", [
    (3, 32, 8, 4096, 128, [0, 4096, 1]),
    (2, 16, 16, 1024, 64, [0, 513]),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_lse_on_card(cuda, B, H, Hkv, T, D, lengths,
                                      dtype):
    """The kernel's log-sum-exp output against the plain version's
    (tolerance of the dtype; -inf exactly on rows of length 0), the
    output the same bits as without it."""
    q, k, v, lens = _attn_inputs(B, H, Hkv, T, D, lengths)
    dt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(cuda, dt) for a in (q, k, v))
    tl = torch.from_numpy(lens).to(cuda)
    out, lse = decode_attention(tq, tk, tv, tl, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    assert torch.equal(out, decode_attention(tq, tk, tv, tl))
    live = torch.from_numpy(lens > 0).to(cuda)
    assert (lse[~live] == -math.inf).all()
    want = decode_attention_plain(tq, tk, tv, tl, return_lse=True)[1]
    tol = _TOL[dtype]
    torch.testing.assert_close(lse[live], want[live], rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_reads_strided_cache_on_card(cuda, dtype):
    """A view of a longer cache with more KV heads (the kernel's tensor
    maps read it through its strides) gives its contiguous copy's bits."""
    q, k, v, lens = _attn_inputs(2, 8, 4, 700, 64, [300, 513])
    dt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(cuda, dt) for a in (q, k, v))
    tl = torch.from_numpy(lens).to(cuda)
    kv = tk[:, :600, 1:3], tv[:, :600, 1:3]
    a = decode_attention(tq[:, 2:6].contiguous(), *kv, tl)
    b = decode_attention(tq[:, 2:6].contiguous(),
                         *(t.contiguous() for t in kv), tl)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


_FLASH_CARD_SHAPES = [
    (1, 128, 2, 2, 64, 128),     # tests/test_kernels.py shapes
    (2, 256, 4, 2, 128, 256),
    (1, 512, 4, 1, 80, 512),
    (1, 1000, 16, 16, 80, 1000),  # hubert width, odd S
    (2, 200, 4, 2, 64, 200),     # odd S, tail tiles
    (1, 1, 4, 4, 64, 1),         # one position
    (2, 37, 9, 3, 16, 37),       # starcoder2 smoke, g = 3
    (1, 61, 6, 1, 20, 61),       # g = 6, Hkv = 1, D = 20 (padded)
    (1, 70, 36, 1, 128, 70),     # g = 36: nine head groups
    (1, 50, 4, 4, 16, 80),       # S < T
    (1, 70, 72, 2, 128, 70),     # g = 36 over two KV heads: groups abut
    (2, 1000, 32, 8, 128, 1000),  # D 128, g 4, an S tail at a 128-row tile
]


def _plan_rows(B, S, H, Hkv):
    """Every (batch, query head, position) row the bf16 kernel's blocks
    serve under :func:`flash_plan`, with its multiplicity, as the kernel
    maps block (x, y) and row r."""
    plan = flash_plan(S, H, Hkv)
    g = H // Hkv
    assert plan.G <= 16 and g % plan.G == 0 and plan.P * plan.G <= 128
    seen = np.zeros((B, H, S), np.int64)
    for x in range(B * Hkv * plan.ngroups):
        hg, bh = x % plan.ngroups, x // plan.ngroups
        b, kvh = bh // Hkv, bh % Hkv
        h0 = kvh * g + hg * plan.G
        assert h0 + plan.G <= (kvh + 1) * g    # never another KV head's rows
        for y in range(plan.ntiles):
            p0 = (plan.ntiles - 1 - y) * plan.P
            r = np.arange(plan.P * plan.G)
            pos, h = p0 + r // plan.G, h0 + r % plan.G
            keep = pos < S
            np.add.at(seen, (b, h[keep], pos[keep]), 1)
    return seen


@pytest.mark.parametrize("B,S,H,Hkv,D,T", _FLASH_CARD_SHAPES)
def test_flash_plan_covers_every_row_once(B, S, H, Hkv, D, T):
    assert (_plan_rows(B, S, H, Hkv) == 1).all()


@settings(max_examples=60, deadline=None)
@given(Hkv=st.integers(1, 8), g=st.integers(1, 40), S=st.integers(1, 600))
def test_flash_plan_covers_every_row_once_sweep(Hkv, g, S):
    assert (_plan_rows(1, S, Hkv * g, Hkv) == 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D,T", _FLASH_CARD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", _FLASH_MASKS + [(True, 1),
                                                          (False, 33)])
def test_flash_attention_kernel_matches_plain_on_card(cuda, B, S, H, Hkv, D,
                                                      T, dtype, causal,
                                                      window):
    dt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(cuda, dt)
                  for a in _flash_inputs(B, S, H, Hkv, D, T))
    before = flash_attention.launches
    out = flash_attention(tq, tk, tv, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.shape == tq.shape and out.dtype == dt
    tol = _TOL[dtype]
    torch.testing.assert_close(
        out.float(), flash_attention_plain(tq, tk, tv, causal=causal,
                                           window=window).float(),
        rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_attention_reads_strided_views_on_card(cuda):
    """q, k and v as views into one fused (B, S, H + 2 Hkv, D) tensor
    give the same result as their contiguous copies."""
    B, S, H, Hkv, D = 2, 130, 8, 2, 64
    g = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):   # FMA and TMA paths
        qkv = torch.randn(B, S, H + 2 * Hkv, D, generator=g).to(cuda, dtype)
        q, k, v = qkv[:, :, :H], qkv[:, :, H:H + Hkv], qkv[:, :, H + Hkv:]
        a = flash_attention(q, k, v)
        b = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_flash_attention_raises_on_shapes_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 2, 256, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)                       # D > 128
    q = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :4], q[:, :4])         # S > T
    with pytest.raises(TypeError):
        flash_attention(q, q.bfloat16(), q.bfloat16())  # mixed dtypes


# --------------------------------------------------------------------------
# Event scan
# --------------------------------------------------------------------------

#: the seeded tables of ``repro_torch.core.seeded`` the tests hold.
_SCAN_NAMES = ("gpu8", "gpu16", "gpu24", "oversized", "serving")


def _scan_rows(table, B, seed=0):
    rng = np.random.default_rng(seed)
    n = len(table.kernels)
    return torch.from_numpy(np.stack([rng.permutation(n) for _ in range(B)])
                            .astype(np.int32))


@pytest.fixture
def ref_core():
    """The reference's ``core`` and its event scan (imported here: the
    card-only tests below do not need JAX)."""
    pytest.importorskip("jax")
    import repro.core as RC
    import repro.core.tpu  # noqa: F401  (RC.tpu)
    from repro.kernels import event_scan as RES
    return SimpleNamespace(C=RC, es=RES)


@pytest.mark.parametrize("name", list(_SCAN_NAMES))
def test_event_times_plain_matches_reference(ref_core, name):
    """The plain scan against the reference's Pallas kernel (interpret
    mode), its jit(vmap) scan and both packages' float64 oracles."""
    table, rtable = scan_table(name), scan_table(name, ref_core.C)
    rows = _scan_rows(table, 6)
    got = event_times_plain(rows, table).numpy()
    assert got.dtype == np.float32 and got.shape == (6,)
    oracle = event_times_reference(rows, table)
    ref_oracle = ref_core.es.event_times_reference(rows.numpy(), rtable)
    assert np.array_equal(oracle, ref_oracle)       # float64, bit for bit
    rtol = event_scan.F32_EVENT_RTOL
    np.testing.assert_allclose(got, oracle, rtol=rtol, atol=0)
    np.testing.assert_allclose(
        got, ref_core.es.event_times_jax(rows.numpy(), rtable), rtol=rtol,
        atol=0)
    np.testing.assert_allclose(
        got, ref_core.es.event_times_pallas(rows.numpy(), rtable,
                                            interpret=True),
        rtol=rtol, atol=0)


def test_event_scan_constants_match_reference(ref_core):
    assert event_scan.F32_EVENT_RTOL == ref_core.es.F32_EVENT_RTOL
    assert event_scan.F32_FIT_RTOL == ref_core.es.F32_FIT_RTOL
    assert event_scan._RETIRE_EPS == ref_core.es._RETIRE_EPS
    for name in ("gpu8", "serving"):
        table, rtable = scan_table(name), scan_table(name, ref_core.C)
        assert tuple(event_scan.config_for_device(table.device)) == \
            tuple(ref_core.es.config_for_device(rtable.device))
        for a, b in zip(event_scan._pack_f32(table),
                        ref_core.es._pack_f32(rtable)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", list(_SCAN_NAMES))
def test_event_scan_cohort_slot_cap(name):
    """C = min(max_resident, n * max grid) slots per unit: never fewer
    than the cohorts any unit holds in the float64 simulation (its
    checkpoints), and the serving device's 4,096 cut to n."""
    table = scan_table(name)
    nbk = event_scan._pack_f32(table)[0]
    n, dev = len(table.kernels), table.device
    C = event_scan.cohort_slots(n, nbk, dev.max_resident)
    assert C == min(dev.max_resident, n * int(nbk.max()))
    if name == "serving":
        assert dev.max_resident == 4096 and C == n
    from repro_torch.core.refine import _FastEventSim
    sim = _FastEventSim(dev)
    for row in _scan_rows(table, 4).tolist():
        _, cps = sim.simulate([table.kernels[i] for i in row], record=True)
        most = max(len(cohorts) for cp in cps for _, _, cohorts in cp.units)
        assert most <= C


@pytest.mark.parametrize("name", ["gpu8", "oversized", "serving"])
def test_event_scan_work_counts(name):
    """The plain version's counts, which the scan's operations bound is
    built from: every block of a fitting kernel admitted once, each
    oversized head drained once, and a first fit that tests at least
    the winning unit and at most every unit, plus one failed attempt per
    admission burst."""
    table = scan_table(name)
    rows = _scan_rows(table, 16, seed=3)
    work = {}
    event_times_plain(rows, table, work=work)
    nbk = event_scan._pack_f32(table)[0]
    dev = table.device
    U = dev.n_units
    alone = np.array([all(k.demands[d] <= dev.cap(d) for d in dev.caps)
                      for k in table.kernels])
    assert work["admissions"] == int((nbk * alone)[rows.numpy()].sum())
    assert work["solo"] == int((~alone)[rows.numpy()].sum())
    bursts = work["completions"] + work["solo"] + rows.shape[0]
    assert work["admissions"] <= work["tested_units"] \
        <= U * (work["admissions"] + bursts)
    assert 0 < work["unit_events"] <= work["slot_events"]
    assert work["unit_events"] <= U * work["completions"]


def test_event_scan_budget_and_bad_rows_raise():
    table = scan_table("gpu8")
    rows = _scan_rows(table, 2)
    with pytest.raises(RuntimeError, match="budget"):
        event_times_plain(rows, table, max_events=3)
    with pytest.raises(ValueError):
        event_times(rows + 100, table)
    with pytest.raises(TypeError):
        event_times(rows.float(), table)
    assert event_times(rows[:0], table).shape == (0,)


@pytest.mark.cuda
@pytest.mark.parametrize("name",
                         list(_SCAN_NAMES) + ["gpu12_u5", "gpu16_u40"])
def test_event_scan_kernel_matches_plain_on_card(cuda, name):
    """Every plan (``_SCAN_PLAN_TABLES`` below names the tables that reach
    each) against the plain version and the float64 oracle."""
    table = scan_table(name)
    rows = _scan_rows(table, 512).to(cuda)
    before = event_times.launches
    out = event_times(rows, table)
    torch.cuda.synchronize()
    assert event_times.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (512,)
    rtol = event_scan.F32_EVENT_RTOL
    torch.testing.assert_close(out, event_times_plain(rows, table),
                               rtol=rtol, atol=0)
    oracle = event_times_reference(rows[:32], table)
    np.testing.assert_allclose(out[:32].cpu().numpy(), oracle, rtol=rtol,
                               atol=0)


@pytest.mark.cuda
def test_event_scan_kernel_overrun_and_bad_rows_raise_on_card(cuda):
    table = scan_table("gpu16")
    rows = _scan_rows(table, 8).to(cuda)
    with pytest.raises(RuntimeError, match="budget"):
        event_times(rows, table, max_events=3)
    with pytest.raises(RuntimeError, match="outside the table"):
        event_times(rows + 100, table)
    torch.testing.assert_close(event_times(rows.long(), table),
                               event_times(rows, table), rtol=0, atol=0)


@pytest.mark.cuda
def test_event_scan_kernel_gives_the_same_bits_twice_on_card(cuda):
    for name in _SCAN_PLAN_TABLES:
        table = scan_table(name)
        rows = _scan_rows(table, 300, seed=4).to(cuda)
        assert torch.equal(event_times(rows, table), event_times(rows, table))


#: a table for each plan and row width the wrapper picks: each lane's own
#: arrays on 16 lanes (the GTX580) and on 8 lanes with three idle (5
#: units); shared memory on 1 lane (the serving device, C 24) and on 32
#: lanes that walk 40 units
_SCAN_PLAN_TABLES = {"gpu16": ("private", 16), "gpu12_u5": ("private", 8),
                     "serving": ("shared", 1), "gpu16_u40": ("shared", 32)}


def _table_plan(table, n=None):
    nbk, dem = event_scan._pack_f32(table)[:2]
    cfg = event_scan.config_for_device(table.device)
    C = event_scan.cohort_slots(n or len(table.kernels), nbk,
                                cfg.max_resident)
    return event_scan.event_plan(len(nbk), dem.shape[1], cfg.n_units, C)


def test_event_plan_tables_reach_every_plan():
    """The card tests' and ``chip_smoke.py``'s tables reach each plan at
    the widths above; every GTX580 table of ``SCAN_TABLES`` takes the
    private plan."""
    for name, (kind, width) in _SCAN_PLAN_TABLES.items():
        plan = _table_plan(scan_table(name))
        assert (plan.name, plan.width) == (kind, width)
        assert plan.rows == 4 * (32 // width)
    for name in ("gpu8", "gpu16", "gpu24", "gpu64", "oversized"):
        assert _table_plan(scan_table(name)).private
    assert event_scan.event_plan(5, 4, 32, 8).private
    assert not event_scan.event_plan(5, 5, 32, 8).private
    assert not event_scan.event_plan(5, 4, 32, 9).private
    assert not event_scan.event_plan(5, 4, 33, 8).private
    with pytest.raises(ValueError):
        event_scan.event_plan(5, 3, 0, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("name,private", [
    (name, private) for name, (kind, _) in _SCAN_PLAN_TABLES.items()
    for private in ((True, False) if kind == "private" else (False,))])
@pytest.mark.parametrize("wide", [False, True])
def test_event_scan_every_layout_matches_plain_on_card(cuda, name, private,
                                                       wide):
    """Every layout the entry point takes on these tables (each lane's
    arrays where U, D and C allow, else shared memory; a row on U rounded
    up or on all 32 lanes) gives the wrapper's plan's bits, which hold the
    plain version within ``F32_EVENT_RTOL``."""
    table = scan_table(name)
    plan = _table_plan(table)
    nbk, dem = event_scan._pack_f32(table)[:2]
    cfg = event_scan.config_for_device(table.device)
    C = event_scan.cohort_slots(len(nbk), nbk, cfg.max_resident)
    layout = event_scan._plan(private, 32 if wide else plan.width, len(nbk),
                              dem.shape[1], cfg.n_units, C)
    rows = _scan_rows(table, 257, seed=5).to(cuda)
    got = event_scan._launch(rows, table, None, layout)
    assert torch.equal(got, event_times(rows, table))
    torch.testing.assert_close(got, event_times_plain(rows, table),
                               rtol=event_scan.F32_EVENT_RTOL, atol=0)


# --------------------------------------------------------------------------
# A NumPy twin of the event-scan kernel's burst admission
# --------------------------------------------------------------------------

_F32 = np.float32


def _twin_state(U, D, C):
    return {"used": np.zeros((U, D), _F32), "nres": np.zeros(U, np.int64),
            "kid": np.full((U, C), -1, np.int64),
            "nb": np.zeros((U, C), np.int64), "fr": np.zeros((U, C), _F32),
            "ta": np.full((U, C), -1, _F32)}


def _twin_commit(st, u, m, kid, dk, t):
    """m blocks of kernel ``kid`` on unit u at instant t: m adds of dk in
    sequence, then the cohort of this kernel admitted at this instant
    grows, else the first free slot opens.  False where none is free."""
    for _ in range(m):
        st["used"][u] = st["used"][u] + dk
    st["nres"][u] += m
    nb, kd, ta = st["nb"][u], st["kid"][u], st["ta"][u]
    free = -1
    for c in range(len(nb)):
        if nb[c] > 0:
            if kd[c] == kid and ta[c] == t:
                nb[c] += m
                return True
        elif free < 0:
            free = c
    if free < 0:
        return False
    kd[free], nb[free], st["fr"][u, free], ta[free] = kid, m, _F32(1), t
    return True


def _twin_caps(st, dk, lim, max_res, bleft):
    """The kernel's ``unit_cap``: per unit and dimension the running
    float32 sum of the one-block loop's fit tests, at most
    min(max_res - nres, bleft) blocks."""
    U, D = st["used"].shape
    cap = np.zeros(U, np.int64)
    for u in range(U):
        m = max(min(max_res - int(st["nres"][u]), bleft), 0)
        for d in range(D):
            acc, j = st["used"][u, d], 0
            if dk[d] == 0:
                j = m if acc <= lim[d] else 0
            else:
                while j < m:
                    acc = _F32(acc + dk[d])
                    if not acc <= lim[d]:
                        break
                    j += 1
            m = j
        cap[u] = m
    return cap


def _twin_burst(st, kid, dk, lim, max_res, bleft, rr, t):
    """One burst of the kernel: the caps, the pass P whose sum of
    min(cap, P) first covers bleft (binary search), min(cap, P - 1)
    blocks a unit and one more for the first r units with cap >= P in
    cyclic order from rr.  Returns (blocks placed, new rr, slots ok)."""
    U = len(st["nres"])
    cap = _twin_caps(st, dk, lim, max_res, bleft)
    tot = int(cap.sum())
    if tot == 0:
        return 0, rr, True
    if tot <= bleft:
        P = int(cap.max())
        r = int((cap >= P).sum())
    else:
        lo, hi = 1, int(cap.max())
        while lo < hi:
            mid = (lo + hi) // 2
            if int(np.minimum(cap, mid).sum()) >= bleft:
                hi = mid
            else:
                lo = mid + 1
        P = lo
        r = bleft - int(np.minimum(cap, P - 1).sum())
    take = np.minimum(cap, P - 1)
    seen = last = 0
    for o in range(U):
        u = (rr + o) % U
        if cap[u] >= P:
            if seen < r:
                take[u] += 1
                last = u
            seen += 1
    ok = True
    for u in np.flatnonzero(take):
        ok &= _twin_commit(st, u, int(take[u]), kid, dk, t)
    return min(tot, bleft), (last + 1) % U, ok


def _twin_first_fit(st, kid, dk, lim, max_res, bleft, rr, t):
    """The one-block loop the burst replaces: each block to the first
    unit, in round-robin order from rr, with a resident slot and room in
    every dimension (float32 used + dk <= lim)."""
    U = len(st["nres"])
    placed, ok = 0, True
    while placed < bleft:
        fits = (st["nres"] + 1 <= max_res) & (st["used"] + dk <= lim).all(1)
        if not fits.any():
            break
        u = int(np.flatnonzero(np.roll(fits, -rr))[0] + rr) % U
        ok &= _twin_commit(st, u, 1, kid, dk, t)
        rr = (u + 1) % U
        placed += 1
    return placed, rr, ok


def _event_twin(row, table):
    """One row of the kernel in float32 NumPy: bursts until the head
    blocks, then a solo drain or a completion event (every unit's slots
    summed in slot order, one division per unit for its next retirement),
    until done.  Returns (time, bursts)."""
    nbk, dem, inst, mem = event_scan._pack_f32(table)
    cfg = event_scan.config_for_device(table.device)
    caps = np.asarray(cfg.caps, _F32)
    lim = caps + (caps * _F32(event_scan.F32_FIT_RTOL) + _F32(1e-12))
    U, D, n = cfg.n_units, len(caps), len(row)
    C = event_scan.cohort_slots(n, nbk, cfg.max_resident)
    st = _twin_state(U, D, C)
    rates = (_F32(cfg.compute_rate), _F32(cfg.mem_bw))
    sats = (_F32(cfg.sat_compute), _F32(cfg.sat_memory))
    eps, sat = _F32(1e-12), cfg.sat_idx

    def effs(occ):
        if sat < 0:
            return _F32(1), _F32(1)
        return tuple(np.maximum(np.minimum(_F32(1), occ / s), eps)
                     for s in sats)

    t, head, rr, bleft, bursts = _F32(0), 0, 0, int(nbk[row[0]]), 0
    while True:
        while head < n:
            bursts += 1
            kid = int(row[head])
            placed, rr, ok = _twin_burst(st, kid, dem[kid], lim,
                                         cfg.max_resident, bleft, rr, t)
            assert ok
            bleft -= placed
            if bleft:
                break
            head += 1
            bleft = int(nbk[row[head]]) if head < n else 0
        if st["nres"].sum() == 0:
            if head >= n:
                return t, bursts
            kid = int(row[head])
            ec, em = effs(dem[kid, sat])
            t1 = max(inst[kid] / (rates[0] * ec), mem[kid] / (rates[1] * em))
            t = _F32(t + _F32(np.ceil(_F32(bleft) / _F32(U))) * t1)
            head += 1
            bleft = int(nbk[row[head]]) if head < n else 0
            continue
        occm = st["nb"] > 0
        sc, sm = np.zeros(U, _F32), np.zeros(U, _F32)
        for c in range(C):
            nbf = st["nb"][:, c].astype(_F32)
            k = st["kid"][:, c]
            sc = np.where(occm[:, c], sc + inst[k] * nbf, sc)
            sm = np.where(occm[:, c], sm + mem[k] * nbf, sm)
        ec, em = effs(st["used"][:, sat])
        with np.errstate(divide="ignore", invalid="ignore"):
            lam = np.minimum(rates[0] * ec / np.maximum(sc, eps),
                             rates[1] * em / np.maximum(sm, eps))
            # each unit's least fraction over its rate: the least of the
            # cohorts' quotients, as rounding keeps the order
            least = np.where(occm, st["fr"], np.inf).min(1)
            dt = _F32((least / lam)[occm.any(1)].min())
        t = _F32(t + dt)
        st["fr"] = np.where(occm, st["fr"] - lam[:, None] * dt, st["fr"])
        fin = occm & (st["fr"] <= _F32(event_scan._RETIRE_EPS))
        for d in range(D):
            s = np.zeros(U, _F32)
            for c in range(C):
                s = np.where(fin[:, c], s + dem[st["kid"][:, c], d]
                             * st["nb"][:, c].astype(_F32), s)
            st["used"][:, d] = st["used"][:, d] - s
        st["nres"] -= np.where(fin, st["nb"], 0).sum(1)
        st["nb"] = np.where(fin, 0, st["nb"])


def _twin_table(name):
    import repro_torch.core as core
    if name in core.EXPERIMENTS:
        return core.ProfileTable.build(core.experiment(name), core.GTX580)
    return scan_table(name)


def _twin_rows(table, B):
    """B seeded orders and one that names kernel 0 three times and kernel
    1 twice at the front (same-instant merges)."""
    n = len(table.kernels)
    rows = _scan_rows(table, B, seed=8).numpy()
    rep = np.concatenate([[0, 0, 0, 1, 1], np.arange(n)])[:max(n, 5)]
    return np.concatenate([rows, rep[None].astype(np.int32) % n])


_TWIN_TABLES = ["gpu8", "gpu16", "gpu24", "gpu64", "oversized", "gpu12_u5",
                "gpu16_u40", "EP-6-shm", "EP-6-grid", "BS-6-blk", "EpBs-6",
                "EpBs-6-shm", "EpBsEsSw-8", "serving"]


@pytest.mark.parametrize("name", _TWIN_TABLES)
def test_event_twin_matches_plain(name):
    """The burst twin against ``event_times_plain``: bit for bit on every
    GTX580 table (16, 5 and 40 units) and the six experiments.  On the
    serving device (one unit, C 24) within ``F32_EVENT_RTOL``: the plain
    version's ``sum`` over 24 slots adds in another order than the
    kernel's slot by slot."""
    table = _twin_table(name)
    rows = _twin_rows(table, 3 if name == "gpu64" else 6)
    got = np.array([_event_twin(r, table)[0] for r in rows], _F32)
    want = event_times_plain(torch.from_numpy(rows), table).numpy()
    if name == "serving":
        np.testing.assert_allclose(got, want, rtol=event_scan.F32_EVENT_RTOL,
                                   atol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["gpu8", "oversized", "serving",
                                  "gpu16_u40", "EpBsEsSw-8"])
def test_event_twin_head_steps_match_plain_count(name):
    """``work["head_steps"]`` of the plain version counts the twin's
    bursts: every head admitted whole and every attempt that blocks."""
    table = _twin_table(name)
    rows = _twin_rows(table, 6)
    work = {}
    event_times_plain(torch.from_numpy(rows), table, work=work)
    assert work["head_steps"] == sum(_event_twin(r, table)[1] for r in rows)
    assert work["head_steps"] >= len(rows)


@settings(max_examples=80, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), U=st.sampled_from([1, 5, 16, 40]),
       D=st.integers(1, 4), C=st.sampled_from([1, 3, 8, 24]),
       max_res=st.sampled_from([1, 2, 8, 64, 4096]),
       bleft=st.one_of(st.integers(1, 12), st.integers(1, 300)),
       rr=st.integers(0, 39),
       zero_dims=st.booleans())
def test_event_twin_burst_matches_first_fit(seed, U, D, C, max_res, bleft,
                                            rr, zero_dims):
    """One burst against the one-block first fit on random unit states:
    the blocks placed, the pointer, ``used`` bit for bit, the resident
    counts and the cohort slots.  Units sit a hair under or over their
    room (the ``F32_FIT_RTOL`` slack decides), resident counts near
    max_res, cohorts of the head kernel at this instant (a merge), and
    blocks left past what fits (a blocked head)."""
    rng = np.random.default_rng(seed)
    rr %= U
    caps = rng.choice([48.0, 1024.0, 32768.0, 4096.0 * 1024], D).astype(_F32)
    lim = caps + (caps * _F32(event_scan.F32_FIT_RTOL) + _F32(1e-12))
    dk = (caps * rng.choice([0.01, 0.1, 0.125, 0.3, 0.5], D)).astype(_F32)
    if zero_dims:
        dk[rng.random(D) < 0.5] = 0
    kid, t = 3, _F32(rng.choice([0.0, 0.25]))
    st_ = _twin_state(U, D, C)
    for u in range(U):
        room = rng.integers(0, 6, D)        # whole blocks of headroom ...
        slack = rng.choice([-1.0, 0.0, 0.5, 1.0, 2.0], D)
        # ... then a hair: in ulps of the limit's scale, in or past it
        st_["used"][u] = (caps - room * dk
                          + slack * caps * _F32(event_scan.F32_FIT_RTOL)
                          ).clip(0).astype(_F32)
        st_["nres"][u] = max_res - rng.integers(0, min(max_res, 9) + 1)
        for c in range(C):
            if rng.random() < 0.3 and st_["nres"][u] > 0:
                st_["kid"][u, c] = rng.choice([kid, 1])
                st_["nb"][u, c] = 1
                st_["fr"][u, c] = _F32(rng.random())
                st_["ta"][u, c] = rng.choice([t, _F32(0.5)])
    a, b = ({k: v.copy() for k, v in st_.items()} for _ in range(2))
    got = _twin_burst(a, kid, dk, lim, max_res, bleft, rr, t)
    want = _twin_first_fit(b, kid, dk, lim, max_res, bleft, rr, t)
    assert got[0] == want[0]
    if want[2]:      # a full slot stops the one-block loop mid-burst
        assert got[1:] == want[1:]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    else:
        assert not got[2]


# --------------------------------------------------------------------------
# Mamba selective scan
# --------------------------------------------------------------------------

def _scan_inputs(B, T, Dc, S, seed=6):
    """The reference's test_mamba_scan recipe, from numpy: x, dt =
    softplus(N) / 10, bm, cm, a = -exp(0.3 N) and d, all f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, Dc))
    dt = np.logaddexp(rng.standard_normal((B, T, Dc)), 0.0) * 0.1
    bm = rng.standard_normal((B, T, S))
    cm = rng.standard_normal((B, T, S))
    a = -np.exp(rng.standard_normal((Dc, S)) * 0.3)
    d = rng.standard_normal(Dc)
    return [v.astype(np.float32) for v in (x, dt, bm, cm, a, d)]


#: the reference's test_mamba_scan shapes, and T, Dc and S that are no
#: powers of two
_SCAN_SHAPES = [(1, 64, 32, 8), (2, 128, 64, 16), (2, 100, 48, 12)]


@pytest.mark.parametrize("B,T,Dc,S", _SCAN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_plain_matches_reference(ref, B, T, Dc, S, dtype):
    """The plain version against ``ref.mamba_scan_ref`` and the Pallas
    kernel (interpret mode), at the reference test's tolerances doubled
    as it doubles them (f32 4e-5, bf16 4e-2)."""
    x, dt, bm, cm, a, d = _scan_inputs(B, T, Dc, S)
    (jx, tx), (jdt, tdt), (jb, tb), (jc, tc) = (
        _both(ref.jnp, v, dtype) for v in (x, dt, bm, cm))
    ja, jd = ref.jnp.asarray(a), ref.jnp.asarray(d)
    out = mamba_scan_plain(tx, tdt, tb, tc, torch.from_numpy(a),
                           torch.from_numpy(d))
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, T, Dc)
    tol = 2 * _TOL[dtype]
    for want in (ref.ref.mamba_scan_ref(jx, jdt, jb, jc, ja, jd),
                 ref.ops.mamba_scan(jx, jdt, jb, jc, ja, jd,
                                    interpret=True)):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)
    torch.testing.assert_close(
        ops.mamba_scan(tx, tdt, tb, tc, torch.from_numpy(a),
                       torch.from_numpy(d)), out, rtol=0, atol=0)


#: the CPU shapes, chip_smoke's (B 2, T 1000, Dc 256, S 16), one row of
#: jamba's width, S = 1 and S = 32, the ends of the range, and the shapes
#: that reach the rest of the library's plans on an H100: 2 and 4 states
#: a thread at S 2 and 4, and 8 (1, 2 and 4 lanes a channel) where
#: B 33 x Dc 2048 makes the grid wide enough
_SCAN_CARD_SHAPES = _SCAN_SHAPES + [(2, 1000, 256, 16), (1, 300, 8192, 16),
                                    (1, 70, 40, 1), (2, 70, 24, 32),
                                    (2, 70, 200, 2), (2, 70, 200, 4),
                                    (33, 70, 2048, 8), (33, 70, 2048, 16),
                                    (33, 70, 2048, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,Dc,S", _SCAN_CARD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_kernel_matches_plain_on_card(cuda, B, T, Dc, S, dtype):
    x, dt, bm, cm, a, d = (torch.from_numpy(v).to(cuda)
                           for v in _scan_inputs(B, T, Dc, S))
    dt_ = getattr(torch, dtype)
    x, dt, bm, cm = (v.to(dt_) for v in (x, dt, bm, cm))
    reset_launch_counts()
    out = mamba_scan(x, dt, bm, cm, a, d)
    torch.cuda.synchronize()
    assert launch_counts()["mamba_scan"] == 1
    tol = 2 * _TOL[dtype]
    torch.testing.assert_close(out, mamba_scan_plain(x, dt, bm, cm, a, d),
                               rtol=tol, atol=tol)


# The selective scan's plan (``scan_plan``): the (channel, state) map,
# the card's limits, and the kernel's arithmetic in a plain twin.

#: the scan's plans: the library's choice on an H100 (132 SMs), its 8-
#: and 4-state plans (forced by a card of 1 SM and of many), and the 2
#: states a thread that ``tools/scan_turns.py --probe`` builds
_SCAN_PLANS = {
    "h100": lambda *shape: scan_plan(*shape, 132),
    "8_states": lambda *shape: scan_plan(*shape, 1),
    "4_states": lambda *shape: scan_plan(*shape, 10 ** 9),
    "probe_2_states": lambda *shape: _scan_plan_of(2, *shape),
}
#: every T, Dc and S the scan tests use, and S over its range
_SCAN_PLAN_SHAPES = (_SCAN_CARD_SHAPES
                     + [(1, 4096, 8192, 16), (8, 4096, 8192, 16)]
                     + [(1, 33, 300, S) for S in (1, 2, 3, 5, 8, 12, 16, 17,
                                                  31, 32)])


def _scan_plan_or_none(name, B, T, Dc, S, dtype):
    """Plan ``name``, or None where the probe's states do not fit the card
    (2 states a thread at S > 16 would need more than 227 KB)."""
    try:
        return _SCAN_PLANS[name](B, T, Dc, S, dtype)
    except ValueError:
        assert name == "probe_2_states", "the library's plans take S 1..32"
        return None


@pytest.mark.parametrize("B,T,Dc,S", _SCAN_PLAN_SHAPES)
def test_scan_plan_covers_every_channel_and_state_once(B, T, Dc, S):
    """Under each plan's map of scan threads (block x, thread tid, state
    slot k) every (channel, state) of the scan has exactly one owner, and
    every owner past Dc or S is padding."""
    for name in _SCAN_PLANS:
        plan = _scan_plan_or_none(name, B, T, Dc, S, torch.bfloat16)
        if plan is None:
            continue
        K, L, ch = plan.states, plan.lanes, plan.block_channels
        x, tid, k = np.meshgrid(np.arange(plan.grid[0]),
                                np.arange(ch * L), np.arange(K),
                                indexing="ij")
        c = x * ch + tid // L
        st = (tid % L) * K + k
        live = (c < Dc) & (st < S)
        seen = np.zeros((Dc, S), np.int64)
        np.add.at(seen, (c[live], st[live]), 1)
        assert (seen == 1).all()
        assert K * L >= S and K * L == 1 << (S - 1).bit_length()
        assert plan.grid[0] * ch >= Dc > (plan.grid[0] - 1) * ch


@pytest.mark.parametrize("B,T,Dc,S", _SCAN_PLAN_SHAPES)
def test_scan_plan_fits_the_card(B, T, Dc, S):
    """The grid within CUDA's limits, shared memory within a block's
    227 KB, 256 scan threads, a chunk of whole step groups and a tile of
    4096 values, and each channel's lanes inside one warp, for every plan
    and dtype."""
    for name in _SCAN_PLANS:
        for dtype in (torch.float32, torch.bfloat16):
            plan = _scan_plan_or_none(name, B, T, Dc, S, dtype)
            if plan is None:
                continue
            assert 1 <= plan.grid[0] < 2 ** 31 and plan.grid[1] == B <= 65535
            assert plan.smem <= _SMEM_MAX and plan.threads == 256 + 128
            assert plan.block_channels * plan.lanes == 256
            assert plan.block_channels * plan.chunk == 4096
            assert plan.chunk % plan.group == 0 and plan.group % 4 == 0
            assert plan.group % plan.lanes == 0 and 32 % plan.lanes == 0
            assert plan.states in (1, 2, 4, 8)


def test_scan_plan_takes_eight_states_where_the_grid_is_wide():
    """jamba's B 1 gets 4 states a thread (64 blocks of 8 states would
    leave half of an H100's SMs idle), its B 8 gets 8; S < 8 caps the
    states at S padded; the line between them moves with the SM count."""
    assert scan_plan(1, 4096, 8192, 16, torch.bfloat16, 132).states == 4
    assert scan_plan(8, 4096, 8192, 16, torch.bfloat16, 132).states == 8
    assert scan_plan(8, 4096, 8192, 16, torch.bfloat16, 300).states == 4
    assert scan_plan(1, 4096, 8192, 16, torch.bfloat16, 32).states == 8
    assert scan_plan(64, 16, 32, 4, torch.bfloat16, 132).states == 4
    assert scan_plan(1, 16, 32, 1, torch.bfloat16, 132).states == 1
    # the card tests' shapes reach every plan the library builds
    plans = {(p.states, p.lanes) for p in (
        scan_plan(*shape, dtype, 132) for shape in _SCAN_CARD_SHAPES
        for dtype in (torch.float32, torch.bfloat16))}
    assert plans == {(1, 1), (2, 1), (4, 1), (4, 2), (4, 4), (4, 8),
                     (8, 1), (8, 2), (8, 4)}


def test_scan_plan_raises_where_the_wrapper_refuses():
    for S in (0, 33, 64):
        with pytest.raises(ValueError):
            scan_plan(1, 16, 32, S, torch.float32, 132)
    with pytest.raises(ValueError):
        scan_plan(65536, 16, 32, 16, torch.float32, 132)
    for B, T, Dc in ((0, 16, 32), (1, 0, 32), (1, 16, 0)):
        with pytest.raises(ValueError):
            scan_plan(B, T, Dc, 16, torch.float32, 132)
    with pytest.raises(TypeError):
        scan_plan(1, 16, 32, 16, torch.float16, 132)
    with pytest.raises(ValueError):
        scan_plan(1, 16, 32, 16, torch.float32, 0)
    with pytest.raises(ValueError):
        _scan_plan_of(3, 1, 16, 32, 16, torch.float32)


def _transpose_sum(v):
    """The kernel's transpose-reduce, lane by lane: v (..., L, N) -> (...,
    L, N / L); at the level of partner offset o a lane whose bit o is set
    keeps the upper half, the other the lower, each adding the partner's
    copy of the half it keeps (keep + received)."""
    L = v.shape[-2]
    lanes = np.arange(L)
    o = L // 2
    while o >= 1:
        h = v.shape[-1] // 2
        up = ((lanes & o) != 0)[:, None]
        give = np.where(up, v[..., :h], v[..., h:])
        keep = np.where(up, v[..., h:], v[..., :h])
        v = keep + give[..., lanes ^ o, :]
        o //= 2
    return v


def _scan_twin(x, dt, bm, cm, a, d, plan):
    """The kernel's arithmetic under ``plan`` in plain f32 NumPy: states
    padded to K * L, dA = exp2(dt * (A log2 e)), each lane's partial y
    (the skip D x on the channel's lane 0, then its K states in order) of
    ``group`` steps, summed over the lanes by the transpose-reduce, lane li
    ending with steps li * G / L onward of the group."""
    B, T, Dc = x.shape
    S = bm.shape[-1]
    K, L, G = plan.states, plan.lanes, plan.group
    SP, f32 = K * L, np.float32

    def states(v):   # (..., S) -> (..., L, K), zeros past S
        pad = np.zeros(v.shape[:-1] + (SP,), f32)
        pad[..., :S] = v
        return pad.reshape(v.shape[:-1] + (L, K))

    a2 = states(a.astype(f32) * f32(np.log2(np.e)))          # (Dc, L, K)
    dsk = np.zeros((Dc, L), f32)
    dsk[:, 0] = d
    bs, cs = states(bm.astype(f32)), states(cm.astype(f32))  # (B, T, L, K)
    h = np.zeros((B, Dc, L, K), f32)
    y = np.zeros((B, -(-T // G) * G, Dc), f32)
    for t0 in range(0, T, G):
        part = np.zeros((B, Dc, L, G), f32)
        for i in range(min(G, T - t0)):   # past T: dt = x = B = C = 0
            dv = dt[:, t0 + i, :, None].astype(f32)             # (B, Dc, 1)
            xv = x[:, t0 + i, :, None].astype(f32)
            acc = dsk[None] * xv
            for k in range(K):
                dA = np.exp2(dv * a2[None, :, :, k])
                h[..., k] = h[..., k] * dA + (dv * xv) * bs[:, t0 + i, None, :, k]
                acc = acc + h[..., k] * cs[:, t0 + i, None, :, k]
            part[..., i] = acc
        # lane li ends with steps li * G / L ..; in order they are the group
        y[:, t0:t0 + G] = _transpose_sum(part).reshape(B, Dc, G).transpose(0, 2, 1)
    return y[:, :T]


@pytest.mark.parametrize("B,T,Dc,S", _SCAN_SHAPES + [(1, 70, 40, 1),
                                                     (2, 70, 24, 32),
                                                     (1, 65, 136, 16)])
@pytest.mark.parametrize("plan_name", list(_SCAN_PLANS))
def test_scan_twin_matches_reference(ref, B, T, Dc, S, plan_name):
    """The kernel's arithmetic (the plan's lanes, exp2, the transpose-
    reduce) against ``ref.mamba_scan_ref``, f32, at the reference test's
    tolerance doubled (4e-5)."""
    plan = _scan_plan_or_none(plan_name, B, T, Dc, S, torch.float32)
    if plan is None:
        return
    x, dt, bm, cm, a, d = _scan_inputs(B, T, Dc, S)
    want = np.asarray(ref.ref.mamba_scan_ref(
        *(ref.jnp.asarray(v) for v in (x, dt, bm, cm, a, d))), np.float32)
    got = _scan_twin(x, dt, bm, cm, a, d, plan)
    np.testing.assert_allclose(got, want, rtol=2 * _TOL["float32"],
                               atol=2 * _TOL["float32"])


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 63, 65, 129])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_kernel_step_tails_on_card(cuda, T, dtype):
    """T no multiple of the chunk (64 steps at S 16) or the step group
    (4), at a Dc that leaves a partial channel block."""
    x, dt, bm, cm, a, d = (torch.from_numpy(v).to(cuda)
                           for v in _scan_inputs(2, T, 200, 16))
    dt_ = getattr(torch, dtype)
    x, dt, bm, cm = (v.to(dt_) for v in (x, dt, bm, cm))
    tol = 2 * _TOL[dtype]
    torch.testing.assert_close(mamba_scan(x, dt, bm, cm, a, d),
                               mamba_scan_plain(x, dt, bm, cm, a, d),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_kernel_large_dt_on_card(cuda, dtype):
    """dt up to ~300, where exp(dt A) underflows to 0 and h forgets its
    past at once."""
    x, dt, bm, cm, a, d = (torch.from_numpy(v).to(cuda)
                           for v in _scan_inputs(1, 100, 64, 16, seed=9))
    dt = dt * 1000.0
    dt_ = getattr(torch, dtype)
    x, dt, bm, cm = (v.to(dt_) for v in (x, dt, bm, cm))
    want = mamba_scan_plain(x, dt, bm, cm, a, d)
    tol = 2 * _TOL[dtype]
    torch.testing.assert_close(mamba_scan(x, dt, bm, cm, a, d), want,
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_kernel_same_bits_twice_on_card(cuda, dtype):
    x, dt, bm, cm, a, d = (torch.from_numpy(v).to(cuda)
                           for v in _scan_inputs(2, 300, 520, 16))
    dt_ = getattr(torch, dtype)
    x, dt, bm, cm = (v.to(dt_) for v in (x, dt, bm, cm))
    first = mamba_scan(x, dt, bm, cm, a, d)
    assert torch.equal(first, mamba_scan(x, dt, bm, cm, a, d))


def _scan_on_card(cuda, dtype, B, T, Dc, S, seed=6):
    x, dt, bm, cm, a, d = (torch.from_numpy(v).to(cuda)
                           for v in _scan_inputs(B, T, Dc, S, seed=seed))
    dt_ = getattr(torch, dtype)
    return [v.to(dt_) for v in (x, dt, bm, cm)] + [a, d]


def _same_bits_and_plain(ins, dtype):
    """The kernel twice for the same bits, then against the plain
    version at twice the reference's tolerance."""
    got = mamba_scan(*ins)
    assert torch.equal(got, mamba_scan(*ins))
    tol = 2 * _TOL[dtype]
    torch.testing.assert_close(got, mamba_scan_plain(*ins), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("Dc", [36, 30])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_kernel_unaligned_x_on_card(cuda, Dc, dtype):
    """x and dt as contiguous views one element into their storage, so
    not 16-byte aligned, at a Dc whose rows are no whole 16-byte vectors
    (but 36 in f32): the staging warps' scalar loads and stores and their
    channel tail inside a vector."""
    x, dt, bm, cm, a, d = _scan_on_card(cuda, dtype, 2, 70, Dc, 16)

    def at_offset_1(t):
        v = torch.empty(t.numel() + 1, dtype=t.dtype,
                        device=t.device)[1:].view(t.shape)
        return v.copy_(t)

    xo, dto = at_offset_1(x), at_offset_1(dt)
    assert xo.is_contiguous() and xo.data_ptr() % 16
    _same_bits_and_plain((xo, dto, bm, cm, a, d), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_reads_partial_b_and_c_rows_on_card(cuda, dtype):
    """B and C as slices of a projection whose rows and slices start on
    16-byte boundaries while S * esize (24 bytes: S 12 in bf16, S 6 in
    f32) is no multiple of 16: cp.async pieces that copy part of 16
    bytes and zero the rest."""
    S, col = (12, 8) if dtype == "bfloat16" else (6, 4)
    x, dt, bm, cm, a, d = _scan_on_card(cuda, dtype, 2, 70, 200, S)
    dbc = torch.zeros(2, 70, 6 * col, dtype=x.dtype, device=cuda)
    dbc[..., 2 * col:2 * col + S] = bm
    dbc[..., 4 * col:4 * col + S] = cm
    bv, cv = dbc[..., 2 * col:2 * col + S], dbc[..., 4 * col:4 * col + S]
    assert bv.data_ptr() % 16 == cv.data_ptr() % 16 == 0
    _same_bits_and_plain((x, dt, bv, cv, a, d), dtype)
    torch.testing.assert_close(mamba_scan(x, dt, bv, cv, a, d),
                               mamba_scan(x, dt, bm, cm, a, d),
                               rtol=0, atol=0)


@pytest.mark.parametrize("variant", ["probe", "no_exp", "no_staging"])
def test_scan_turns_variants_edit_the_source_once(variant):
    """``tools/scan_turns.py --probe`` builds edited copies of
    ``csrc/mamba_scan.cu``: each edit still finds its text exactly once,
    and the edited copy differs from the source."""
    import importlib
    import sys
    from pathlib import Path
    tools = Path(__file__).resolve().parents[1] / "tools"
    sys.path.insert(0, str(tools))
    try:
        turns = importlib.import_module("turns")
        scan_turns = importlib.import_module("scan_turns")
    finally:
        sys.path.remove(str(tools))
    src = (tools.parent / "src" / "repro_torch" / "csrc"
           / "mamba_scan.cu").read_text()
    flags, edits = scan_turns.VARIANTS[variant]
    assert turns.edited(src, edits) != src
    with pytest.raises(ValueError):
        turns.edited(src + src, edits)


def test_event_turns_registers_build_edits_the_source_once():
    """``tools/event_turns.py`` builds its ``registers`` ablation from an
    edited copy of ``csrc/event_scan.cu``: each edit still finds its text
    exactly once, and the edited copy differs from the source."""
    import importlib
    import sys
    from pathlib import Path
    tools = Path(__file__).resolve().parents[1] / "tools"
    sys.path.insert(0, str(tools))
    try:
        turns = importlib.import_module("turns")
        event_turns = importlib.import_module("event_turns")
    finally:
        sys.path.remove(str(tools))
    src = (tools.parent / "src" / "repro_torch" / "csrc"
           / "event_scan.cu").read_text()
    flags, edits = event_turns.VARIANTS["registers"]
    assert turns.edited(src, edits) != src
    with pytest.raises(ValueError):
        turns.edited(src + src, edits)


@pytest.mark.cuda
def test_mamba_scan_reads_strided_b_and_c_on_card(cuda):
    """bm and cm as the model passes them: slices of one projection."""
    x, dt, bm, cm, a, d = (torch.from_numpy(v).to(cuda)
                           for v in _scan_inputs(2, 150, 64, 16))
    dbc = torch.cat([torch.zeros_like(bm[..., :5]), bm, cm], dim=-1)
    got = mamba_scan(x, dt, dbc[..., 5:21], dbc[..., 21:], a, d)
    torch.testing.assert_close(got, mamba_scan(x, dt, bm, cm, a, d),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_mamba_scan_raises_on_inputs_it_does_not_take(cuda):
    x, dt, bm, cm, a, d = (torch.from_numpy(v).to(cuda)
                           for v in _scan_inputs(1, 16, 32, 8))
    with pytest.raises(TypeError):
        mamba_scan(x, dt, bm, cm, a.bfloat16(), d)
    with pytest.raises(TypeError):
        mamba_scan(x.bfloat16(), dt, bm, cm, a, d)
    with pytest.raises(ValueError):
        mamba_scan(x, dt[:, :8], bm, cm, a, d)
    with pytest.raises(ValueError):
        mamba_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, bm,
                   cm, a, d)
    with pytest.raises(ValueError):
        mamba_scan(x, dt, bm, cm, a.t().contiguous().t(), d)
    with pytest.raises(ValueError):
        mamba_scan(x, dt, bm, cm, a, d.cpu())
    big = torch.zeros(1, 16, 33, device=cuda)
    with pytest.raises(ValueError):
        mamba_scan(x, dt, big, big, torch.zeros(32, 33, device=cuda), d)


@pytest.mark.cuda
def test_jamba_smoke_forward_kernels_match_xla_on_card(cuda):
    """The seeded f32 jamba smoke model on the card: the forward through
    the scan and flash kernels against ``impl="xla"`` (TF32 off), with
    one scan launch per Mamba layer and one flash launch."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("jamba-v0.1-52b", "smoke").replace(dtype="float32")
    params = T.init(cfg, seed=0, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, size=(2, 100))).to(cuda)
    reset_launch_counts()
    with torch.inference_mode():
        a, aux_a = T.forward(params, cfg, toks)
        counts = launch_counts()
        b, aux_b = T.forward(params, cfg, toks, impl="xla")
    n_mamba = sum(cfg.layer_kind(i) == "mamba" for i in range(cfg.n_layers))
    assert counts["mamba_scan"] == n_mamba == 7
    assert counts["flash_attention"] == 1
    assert (a - b).abs().max().item() < 1e-3
    for k in aux_a:
        assert abs(float(aux_a[k]) - float(aux_b[k])) < 1e-5
