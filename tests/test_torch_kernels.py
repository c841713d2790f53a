"""The port's RMSNorm and decode-attention kernels.

On the CPU the wrappers run their plain versions, checked here against
the reference's Pallas kernels (interpret mode) and pure-jnp oracles at
the reference's tolerances (``tests/test_kernels.py``: f32 2e-5, bf16
2e-2).  Tests marked ``cuda`` hold the CUDA kernels against their plain
versions on the card at the shapes of the serving path; they skip where
no CUDA device is present (``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_*.py`` on the card).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import (decode_attention, decode_attention_plain,
                                 launch_counts, ops, reset_launch_counts,
                                 rmsnorm_rows, rmsnorm_rows_plain)

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
    assert launch_counts() == {"rmsnorm": 0, "decode_attention": 0}


# --------------------------------------------------------------------------
# On the card: kernel vs plain version
# --------------------------------------------------------------------------

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
@pytest.mark.parametrize("B,H,Hkv,T,D,lengths", [
    (1, 16, 16, 512, 64, [1]),
    (1, 16, 16, 512, 64, [100]),
    (1, 16, 16, 512, 64, [511]),
    (1, 16, 16, 512, 64, [512]),
    (4, 32, 8, 4096, 128, [1, 1000, 4095, 4096]),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_kernel_matches_plain_on_card(cuda, B, H, Hkv, T, D,
                                                       lengths, dtype):
    q, k, v, lens = _attn_inputs(B, H, Hkv, T, D, lengths)
    dt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(cuda, dt) for a in (q, k, v))
    tl = torch.from_numpy(lens).to(cuda)
    before = decode_attention.launches
    out = decode_attention(tq, tk, tv, tl)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    tol = _TOL[dtype]
    torch.testing.assert_close(
        out.float(), decode_attention_plain(tq, tk, tv, tl).float(),
        rtol=tol, atol=tol)
