"""The port's roofline (``repro_torch.roofline``) against the JAX
reference's (``repro.roofline``), on the CPU.

* ``cell_flops``, ``cell_bytes`` (256 and 512 devices, ``accum`` from
  ``TRAIN_ACCUM``), ``active_params`` and ``model_flops`` are host float
  arithmetic on the same configs: bit-equal for the ten archs and four
  shapes.  The parameter count behind ``cell_bytes`` is the port's
  ``meta`` init, the reference's ``jax.eval_shape``: equal.
* ``roofline_row`` equals the reference's on records made here, with the
  reference's ``HW`` values, in a temporary working directory (no
  ``roofline_correction.json``), and with one there.
* ``HW`` defaults to one H100 SXM's figures.
* The correction's measured-to-analytic unit-FLOP ratios are pinned
  (exact integer FLOP counts over float arithmetic: 1e-12 relative).
"""

import dataclasses
import functools
import json

import pytest

import repro.configs as ref_configs
import repro.roofline as RR
import repro.roofline.analysis as RA
import repro.roofline.flops as RF
from repro.launch.dryrun import TRAIN_ACCUM

import repro_torch.roofline as PR
import repro_torch.roofline.analysis as PA
import repro_torch.roofline.flops as PF
from repro_torch.configs import get_config
from repro_torch.roofline.correction import validate_flops
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ref_configs.arch_names()
SHAPE_NAMES = list(ref_configs.SHAPES)


@pytest.fixture(scope="module", autouse=True)
def _cached_ref_param_count():
    """The reference's ``_param_count`` traces its init for every call;
    memoise it (the same function) for this module's 80 calls."""
    orig = RF._param_count
    RF._param_count = functools.lru_cache(maxsize=None)(orig)
    yield
    RF._param_count = orig


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(arch):
    assert PF._param_count(get_config(arch, "full")) == RF._param_count(
        ref_configs.get_config(arch, "full"))


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_and_bytes_bit_equal(arch):
    for shape in SHAPE_NAMES:
        assert PF.cell_flops(arch, shape) == RF.cell_flops(arch, shape)
        for n in (256, 512):
            accum = TRAIN_ACCUM.get(arch, 1)
            assert PF.cell_bytes(arch, shape, n, accum=accum) == \
                RF.cell_bytes(arch, shape, n, accum=accum)
        assert PA.model_flops(arch, shape) == RA.model_flops(arch, shape)
    assert PA.active_params(get_config(arch)) == RA.active_params(
        ref_configs.get_config(arch))
    cfg, rcfg = get_config(arch), ref_configs.get_config(arch)
    for i in range(cfg.n_layers):
        assert PF.layer_fwd_flops_per_token(cfg, i, 1234.5) == \
            RF.layer_fwd_flops_per_token(rcfg, i, 1234.5)


def _records():
    out = []
    for i, arch in enumerate(ARCHS):
        for j, shape in enumerate(SHAPE_NAMES):
            n = 256 if (i + j) % 2 else 512
            rec = {"arch": arch, "shape": shape,
                   "mesh": "16x16" if n == 256 else "2x16x16",
                   "n_devices": n,
                   "memory": {"peak_bytes": 1.5e9 + 1e7 * i + j},
                   "cost": {"flops": 3.25e13 * (1 + i) + j},
                   "collectives": {"all-gather": 1e9 + i,
                                   "all-reduce": 2e8 * (j + 1)}}
            if shape == "train_4k" and i % 3 == 0:
                rec["accum"] = 2
            out.append(rec)
    out.append({"arch": "qwen1.5-0.5b", "shape": "long_500k",
                "skipped": "pure full-attention architecture"})
    out.append({"arch": "qwen1.5-0.5b", "shape": "x", "error": "boom"})
    return out


def _rows_equal(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(RA, "_CORR", None)
    monkeypatch.setattr(PA, "_CORR", None)
    ref_hw = RR.HW()
    hw = PR.HW(**dataclasses.asdict(ref_hw))
    for rec in _records():
        assert PR.roofline_row(rec, hw) == RR.roofline_row(rec, ref_hw)
    path = tmp_path / "records.json"
    path.write_text(json.dumps(_records()))
    assert PR.analyse(str(path), hw) == RR.analyse(str(path), ref_hw)
    assert PR.load_records(str(path)) == RR.load_records(str(path))


def test_roofline_row_matches_reference(tmp_path, monkeypatch):
    _rows_equal(tmp_path, monkeypatch)


def test_roofline_row_matches_reference_with_corrections(tmp_path,
                                                         monkeypatch):
    (tmp_path / "roofline_correction.json").write_text(json.dumps(
        {"qwen1.5-0.5b": {"unit_coll_bytes": 3.5e8, "reps_full": 24},
         "mixtral-8x7b": {"unit_coll_bytes": 1.25e9, "reps_full": 32}}))
    _rows_equal(tmp_path, monkeypatch)


def test_hw_is_the_h100():
    hw = PR.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12, 450e9)


def test_exports_match_reference():
    assert set(RR.__all__) == set(PR.__all__)
    assert set(RA.__all__) <= set(PA.__all__)
    assert set(RF.__all__) <= set(PF.__all__)


#: measured / analytic FLOPs of one layer unit, the whole cell on one
#: device (``validate_flops``): the plain attention computes every
#: (query, key) pair, where the analytic term counts the causal half
#: (qwen; less at 4,096 tokens than at 32,768, attention being a smaller
#: share of a layer's FLOPs there) or the 4,096-token window (mixtral's prefill; its train cell's
#: blockwise attention visits all 4,096 keys of each query block, the
#: window being the whole sequence there)
_RATIOS = {("qwen1.5-0.5b", "train_4k"): 1.2037738116699717,
           ("qwen1.5-0.5b", "prefill_32k"): 1.7231258137841237,
           ("mixtral-8x7b", "prefill_32k"): 1.4552556367100666,
           ("mixtral-8x7b", "train_4k"): 1.0336027571493045}


@pytest.mark.parametrize("arch,shape", list(_RATIOS))
def test_correction_ratio_pinned(arch, shape):
    r = validate_flops(arch, shape)
    assert r["ratio"] == pytest.approx(_RATIOS[arch, shape], rel=1e-12)
    assert r["n_devices"] == 1 and r["unit"]["coll"] == 0.0
    assert r["depth2"]["flops"] > r["depth1"]["flops"] > 0
