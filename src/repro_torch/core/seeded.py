"""Seeded kernel-profile tables for the port's checks: the parity tests
and ``chip_smoke.py`` draw their tables from here, so both hold the
same inputs.

The generators are the reference test suite's: ``gpu_kernels`` and
``oversized`` as ``tests/test_batched.py`` builds them, ``adversarial``
as ``tests/test_event_delta.py`` does, ``serving_profiles`` as its
serving-device cases do.  Each takes the package ``C`` to build in (this
package's ``core``, or the reference's for a side-by-side comparison)
and a ``random.Random``, so one seed gives the same profiles in both.
"""

from __future__ import annotations

import dataclasses
import random

__all__ = ["FAMS", "gpu_kernels", "oversized", "adversarial",
           "serving_profiles", "SCAN_TABLES", "scan_table"]

#: the four kernel families of the paper's GTX580 experiments.
FAMS = ("ep_kernel", "bs_kernel", "es_kernel", "sw_kernel")


def _core():
    from .. import core
    return core


def gpu_kernels(C, rng: random.Random, n: int) -> list:
    """Random GTX580 profiles of the four families."""
    return [getattr(C, rng.choice(FAMS))(
        f"k{i}", grid=rng.choice([8, 16, 32, 48, 64, 96]),
        shm=rng.choice([0, 4096, 8192, 16384, 24576]),
        inst=rng.uniform(1e6, 5e8)) for i in range(n)]


def _odd_profiles(C, rng: random.Random, n: int, at_cap: bool) -> list:
    ks = []
    for i in range(n):
        roll = rng.random()
        if roll < (0.2 if at_cap else 0.5):     # oversized in one dim
            dem = {"shm": rng.choice([49152.0, 96000.0]),
                   "reg": rng.uniform(100, 3000.0), "warp": 4.0}
        elif at_cap and roll < 0.4:             # fits alone, nothing joins
            dem = {"shm": 48 * 1024.0, "reg": 1024.0, "warp": 48.0}
        else:
            dem = {"shm": rng.choice([0.0, 8192.0]),
                   "reg": rng.uniform(512, 8192.0),
                   "warp": float(rng.choice([1, 4, 8, 16]))}
        ks.append(C.KernelProfile(
            f"a{i}", n_blocks=rng.choice([1, 3, 7, 17, 33]),
            demands=dem, inst_per_block=rng.uniform(1e2, 1e9),
            r=rng.choice([1e-6, 0.5, 4.0, 1e6])))
    return ks


def oversized(C, rng: random.Random, n: int) -> list:
    """Profiles whose blocks exceed the GTX580 in some dimension about
    half the time: the event model's solo-drain branch."""
    return _odd_profiles(C, rng, n, at_cap=False)


def adversarial(C, rng: random.Random, n: int) -> list:
    """The simulators' edge paths: oversized blocks, blocks exactly at
    capacity, intensities over 12 orders of magnitude, tiny grids."""
    return _odd_profiles(C, rng, n, at_cap=True)


def serving_profiles(C, rng: random.Random, n: int) -> list:
    """Prefill and decode items of a 7B model on the serving device (one
    unit, 4,096 resident blocks)."""
    items = []
    for i in range(n):
        if rng.random() < 0.4:
            items.append(C.tpu.prefill_profile(
                f"p{i}", n_params=7e9,
                seq_len=rng.choice([128, 256, 512, 1024]),
                kv_bytes_per_token=131072))
        else:
            items.append(C.tpu.decode_profile(
                f"d{i}", n_params=7e9, kv_len=rng.randint(1, 8192),
                kv_bytes_per_token=131072))
    return [it.profile() for it in items]


#: the event scan's check tables: name -> (generator, n, seed, units);
#: units, where given, replaces the GTX580's 16 (5: rows on 8 lanes with
#: three idle; 40: more units than a warp has lanes).
SCAN_TABLES = {"gpu8": (gpu_kernels, 8, 500, None),
               "gpu16": (gpu_kernels, 16, 501, None),
               "gpu24": (gpu_kernels, 24, 502, None),
               "gpu64": (gpu_kernels, 64, 503, None),
               "oversized": (oversized, 12, 600, None),
               "serving": (serving_profiles, 24, 700, None),
               "gpu12_u5": (gpu_kernels, 12, 504, 5),
               "gpu16_u40": (gpu_kernels, 16, 505, 40)}


def scan_table(name: str, C=None):
    """The ``ProfileTable`` of ``SCAN_TABLES[name]`` in package ``C``
    (this package's ``core`` by default), on the serving device for
    "serving" and on the GTX580 otherwise, with ``units`` units where
    the entry gives them."""
    C = C or _core()
    maker, n, seed, units = SCAN_TABLES[name]
    dev = C.tpu.make_serving_device() if name == "serving" else C.GTX580
    if units is not None:
        dev = dataclasses.replace(dev, name=f"{dev.name}_x{units}",
                                  n_units=units)
    return C.ProfileTable.build(maker(C, random.Random(seed), n), dev)
