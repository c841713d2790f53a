"""The event scan: event-model makespans of many launch orders at once —
the CUDA kernel's wrapper, its plain version and the float64 oracle.

Replaces the Pallas TPU kernel ``event_times_pallas``
(``src/repro/kernels/event_scan.py:295``, body ``event_scan_core``).
Each row of ``rows`` (B, n) is a launch order, as indices into
``table.kernels`` of a :class:`~repro_torch.core.fastscore.ProfileTable`;
the result is the (B,) float32 makespan of every order under the event
model of :class:`~repro_torch.core.refine._FastEventSim` from a fresh
start: per-block round-robin first-fit admission with same-instant
cohort merge, per-unit roofline rates, completion events at
``min(frac / lam)``, and oversized heads draining alone in
``ceil(blocks / n_units)`` solo passes.

* :func:`event_times` launches the kernel (``csrc/event_scan.cu``) for
  CUDA ``rows`` and runs :func:`event_times_plain` only for rows on the
  CPU; on a CUDA tensor it launches or raises.  ``event_times.launches``
  counts the kernel's launches.  It is bound by float32 operations: a
  row is a chain of data-dependent steps, so the kernel cuts the steps
  and fills the warps.  One step admits the whole head kernel (a burst:
  each unit counts the blocks it can still take, and the round-robin
  first fit follows in closed form, bit for bit the one-block loop's),
  and a warp carries 32 / W rows of W lanes, a lane per unit (W = U
  rounded up to a power of two, at most 32).  :func:`event_plan` picks
  where the units' state lives, in arrays of each lane or in shared
  memory (the source note in the ``.cu`` file has the details).
* :func:`event_times_plain` is the same float32 scan in PyTorch,
  vectorised over the rows with masks for rows that are done.
* :func:`event_times_reference` is the float64 oracle: the port's own
  ``_FastEventSim`` on each row.

float32 deviations from the float64 reference, as in the reference
package:

* admission slack — the reference admits on ``used + dem <= cap +
  1e-12``; in float32 the accumulated ``used`` carries ~1e-7 relative
  rounding, so the scan uses ``cap * F32_FIT_RTOL`` slack instead,
  well below any per-block demand (what real rejections are measured
  in) but above float32 accumulation noise, which keeps admission
  decisions equal to the reference's;
* retirement threshold — ``frac <= 1e-6`` (the reference: 1e-9, which
  float32 cannot resolve against O(1) fractions);
* times — event instants accumulate float32 rounding over O(n) events;
  :data:`F32_EVENT_RTOL` bounds the relative error against the
  reference.

Every scan has a budget: admissions, completions and solo drains of a
row cannot exceed ``2 * (its kernels' blocks) + n``.  A row that
overruns it (or ``max_events``, where given), fills its cohort slots or
names a kernel outside the table raises :class:`RuntimeError`; the scan
never spins and never returns such a row's time.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .build import library
from .nograd import refuse_grad

__all__ = ["F32_EVENT_RTOL", "F32_FIT_RTOL", "EventPlan", "EventScanConfig",
           "config_for_device", "cohort_slots", "event_plan", "event_times",
           "event_times_plain", "event_times_reference"]

#: relative tolerance of float32 scan times vs the float64
#: ``_FastEventSim`` (the reference package's; observed error ~1e-6).
F32_EVENT_RTOL = 5e-4

#: admission slack as a fraction of each capacity (see module docstring).
F32_FIT_RTOL = 1e-5

#: float32 retirement threshold (reference: 1e-9 in float64).
_RETIRE_EPS = 1e-6

_EPS = 1e-12

_WARPS = 4          # warps a block (csrc/event_scan.cu kWarps)
_LANE_D, _LANE_C = 4, 8   # the private plan's largest D, C (kLaneD, kLaneC)


class EventPlan(NamedTuple):
    """The kernel's launch: ``private`` (each lane holds its unit's state
    in arrays of its own) or shared memory; ``width`` lanes a row, so a
    block of 4 warps carries ``rows`` rows; ``smem`` dynamic shared-memory
    bytes a block (the kernel table, and the rows' state in the shared
    plan)."""
    private: bool
    width: int
    rows: int
    smem: int

    @property
    def name(self) -> str:
        return "private" if self.private else "shared"


def event_plan(K: int, D: int, U: int, C: int) -> EventPlan:
    """The plan for a table of K kernels in D dimensions on U units with
    C cohort slots a unit: a row on ``width`` = U rounded up to a power
    of two lanes (at most 32; past 32 units each lane walks several),
    its units' state in each lane's arrays where U <= 32, D <= 4 and
    C <= 8 (every GTX580 table), else in shared memory."""
    if min(K, D, U, C) < 1:
        raise ValueError(f"event scan: no plan for K={K}, D={D}, U={U}, "
                         f"C={C}")
    return _plan(U <= 32 and D <= _LANE_D and C <= _LANE_C,
                 min(1 << (U - 1).bit_length(), 32), K, D, U, C)


def _plan(private: bool, width: int, K: int, D: int, U: int,
          C: int) -> EventPlan:
    """The layout of a plan; the wrapper runs the ones :func:`event_plan`
    picks, and the entry point takes any width from U rounded up to 32
    (the turns tool times the others)."""
    table = 4 * (3 * K + K * D + D)
    row = 4 * (U * D + 3 * U + 4 * U * C)
    rows = _WARPS * (32 // width)
    return EventPlan(private, width, rows,
                     table + (0 if private else rows * row))


class EventScanConfig(NamedTuple):
    """Static device geometry for the scan."""

    caps: tuple          # per-dim capacities, device.caps order
    n_units: int
    max_resident: int
    sat_idx: int         # index of sat_dim in caps order, -1 if absent
    compute_rate: float
    mem_bw: float
    sat_compute: float
    sat_memory: float


def config_for_device(device) -> EventScanConfig:
    dims = tuple(device.caps)
    return EventScanConfig(
        caps=tuple(device.cap(d) for d in dims),
        n_units=int(device.n_units),
        max_resident=int(device.max_resident),
        sat_idx=(dims.index(device.sat_dim)
                 if device.sat_dim in dims else -1),
        compute_rate=float(device.compute_rate),
        mem_bw=float(device.mem_bw),
        sat_compute=float(device.sat_compute),
        sat_memory=float(device.sat_memory),
    )


def _pack_f32(table):
    """Kernel-table arrays for the scan, cached on the ProfileTable."""
    cached = getattr(table, "_event_scan_pack", None)
    if cached is not None:
        return cached
    dev = table.device
    dims = tuple(dev.caps)
    dem = np.stack([
        np.array([k.demands.get(d, 0.0) for d in dims], dtype=np.float32)
        for k in table.kernels])
    pack = (
        np.array([int(k.n_blocks) for k in table.kernels], dtype=np.int32),
        dem,
        np.array([k.inst_per_block for k in table.kernels],
                 dtype=np.float32),
        np.array([k.mem_per_block() for k in table.kernels],
                 dtype=np.float32),
    )
    table._event_scan_pack = pack
    return pack


def _device_pack(table, device: torch.device):
    """``(nbk, dem, inst, mem, caps)`` as tensors on ``device``, moved
    there once per table and device."""
    packs = getattr(table, "_event_scan_tensors", None)
    if packs is None:
        packs = table._event_scan_tensors = {}
    pack = packs.get(device)
    if pack is None:
        cfg = config_for_device(table.device)
        pack = packs[device] = tuple(
            torch.from_numpy(a).to(device).contiguous()
            for a in (*_pack_f32(table),
                      np.asarray(cfg.caps, dtype=np.float32)))
    return pack


def cohort_slots(n: int, nbk: np.ndarray, max_resident: int) -> int:
    """Cohort slots per unit for orders of ``n`` kernels drawn from a
    table whose grids are ``nbk``: ``min(max_resident, n * max grid)``.

    A slot holds at least one resident block, and a unit holds at most
    ``max_resident`` blocks, nor more than the order's blocks (at most
    ``n`` times the largest grid), so no unit ever needs more — the
    reference's ``max(max_resident, 1)`` slots (4,096 on the serving
    device) give the same times."""
    most = n * int(np.max(nbk)) if len(nbk) else 0
    return max(min(int(max_resident), most), 1)


def _check_rows(rows: torch.Tensor) -> None:
    if rows.dim() != 2:
        raise ValueError(f"event scan: want rows (B, n), got "
                         f"{tuple(rows.shape)}")
    if rows.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"event scan: rows dtype {rows.dtype} not in "
                        "(int32, int64)")


def event_times_plain(rows: torch.Tensor, table, *,
                      max_events: int | None = None,
                      work: dict | None = None) -> torch.Tensor:
    """The float32 scan in PyTorch on ``rows``' device: rows (B, n) int
    -> (B,) float32, every row advanced in lockstep (admission until
    blocked, then one event) with masks for the rows that are done.

    ``work``, where given, is a dict that receives the scan's counts
    over all rows: ``admissions`` (blocks placed), ``tested_units``
    (units a sequential first fit tests: from the round-robin pointer to
    the winner for each admission, all ``U`` for the attempt that ends
    each admission burst), ``head_steps`` (the kernel's bursts: every
    head kernel admitted whole, and every attempt on a head that
    blocks), ``completions`` (completion events),
    ``unit_events`` and ``slot_events`` (occupied units and cohort slots
    summed over the completion events) and ``solo`` (oversized heads
    drained) — what a bound on the scan's operations counts."""
    dev = rows.device
    nbk, dem, inst_b, mem_b, caps = _device_pack(table, dev)
    cfg = config_for_device(table.device)
    _check_rows(rows)
    K = nbk.shape[0]
    if rows.numel() and (int(rows.min()) < 0 or int(rows.max()) >= K):
        raise ValueError(f"event scan: kernel indices outside [0, {K})")
    rows = rows.long()
    B, n = rows.shape
    if B == 0 or n == 0:
        return torch.zeros(B, dtype=torch.float32, device=dev)
    U, D = cfg.n_units, len(cfg.caps)
    C = cohort_slots(n, _pack_f32(table)[0], cfg.max_resident)
    f32, i64 = torch.float32, torch.int64
    nbk = nbk.long()
    lim = caps + (caps * F32_FIT_RTOL + _EPS)          # (D,)
    max_res = cfg.max_resident
    sat = cfg.sat_idx

    def eff(occ, s):
        return torch.clamp(torch.clamp(occ / s, max=1.0), min=_EPS)

    t = torch.zeros(B, dtype=f32, device=dev)
    head = torch.zeros(B, dtype=i64, device=dev)
    rr = torch.zeros(B, dtype=i64, device=dev)
    bleft = nbk[rows[:, 0]]
    used = torch.zeros(B, U, D, dtype=f32, device=dev)
    nres = torch.zeros(B, U, dtype=i64, device=dev)
    ckn = torch.full((B, U, C), -1, dtype=i64, device=dev)
    cnb = torch.zeros(B, U, C, dtype=i64, device=dev)
    cfr = torch.zeros(B, U, C, dtype=f32, device=dev)
    cta = torch.full((B, U, C), -1.0, dtype=f32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    events = torch.zeros(B, dtype=i64, device=dev)
    budget = (2 * nbk[rows].sum(1) + n if max_events is None
              else torch.full((B,), int(max_events), dtype=i64, device=dev))
    bidx = torch.arange(B, device=dev)
    uidx = torch.arange(U, device=dev)
    counts = dict.fromkeys(("admissions", "tested_units", "head_steps",
                            "completions", "unit_events", "slot_events",
                            "solo"), 0)

    def head_kid():
        return rows[bidx, head.clamp(max=n - 1)]

    slots_ok = torch.ones((), dtype=torch.bool, device=dev)

    def check_budget():
        # once per event: the admissions between two events are bounded
        # by the blocks, so an overrun shows at the next check
        if not bool(slots_ok):
            raise RuntimeError("event scan: a unit ran out of cohort slots")
        if bool((events > budget).any()):
            raise RuntimeError("event scan: a row overran its event budget")

    while not bool(done.all()):
        # -- admission: one block per row and pass, while one fits
        head0, trying = head, ~done
        while True:
            kid = head_kid()
            dk = dem[kid]                                     # (B, D)
            fits = ((nres + 1 <= max_res)
                    & ((used + dk[:, None, :]) <= lim).all(-1))
            adm = ~done & (head < n) & fits.any(1)
            if not bool(adm.any()):
                if work is not None:     # each trying row's failed attempt
                    counts["tested_units"] += U * int(
                        (~done & (head < n)).sum())
                break
            off = (uidx[None, :] - rr[:, None]) % U
            win = torch.where(fits, off, U).amin(1)         # cyclic offset
            u = (rr + win) % U
            ab, au, ak = bidx[adm], u[adm], kid[adm]
            used[ab, au] = used[ab, au] + dk[adm]
            nres[ab, au] += 1
            snb, skn = cnb[ab, au], ckn[ab, au]               # (A, C)
            match = (snb > 0) & (skn == ak[:, None]) \
                & (cta[ab, au] == t[adm][:, None])
            free = snb == 0
            has = match.any(1)
            slots_ok &= (has | free.any(1)).all()
            slot = torch.where(has, match.int().argmax(1),
                               free.int().argmax(1))
            cnb[ab, au, slot] += 1
            ckn[ab, au, slot] = ak
            cfr[ab, au, slot] = torch.where(has, cfr[ab, au, slot], 1.0)
            cta[ab, au, slot] = t[adm]
            rr = torch.where(adm, (u + 1) % U, rr)
            bleft = bleft - adm.long()
            adv = adm & (bleft == 0)
            head = head + adv.long()
            bleft = torch.where(adv & (head < n), nbk[head_kid()], bleft)
            events += adm.long()
            if work is not None:
                counts["admissions"] += int(adm.sum())
                counts["tested_units"] += int((win + 1)[adm].sum())
        if work is not None:     # heads admitted whole, and the one blocked
            counts["head_steps"] += int(
                ((head - head0) + (head < n).long())[trying].sum())
        nres_tot = nres.sum(1)
        done |= (nres_tot == 0) & (head >= n)
        # -- oversized heads drain alone
        over = ~done & (nres_tot == 0)
        if bool(over.any()):
            kid = head_kid()
            if sat >= 0:
                occ = dem[kid, sat]
                eff_c, eff_m = eff(occ, cfg.sat_compute), \
                    eff(occ, cfg.sat_memory)
            else:
                eff_c = eff_m = torch.ones(B, dtype=f32, device=dev)
            t1 = torch.maximum(inst_b[kid] / (cfg.compute_rate * eff_c),
                               mem_b[kid] / (cfg.mem_bw * eff_m))
            passes = torch.ceil(bleft.to(f32) / U)
            t = torch.where(over, t + passes * t1, t)
            head = head + over.long()
            bleft = torch.where(over & (head < n), nbk[head_kid()], bleft)
            events += over.long()
            if work is not None:
                counts["solo"] += int(over.sum())
        # -- completion: advance to the next retirement
        run = ~done & (nres_tot > 0)
        if bool(run.any()):
            occm = cnb > 0
            kc = ckn.clamp(min=0)
            nbf = cnb.to(f32)
            sum_c = (inst_b[kc] * nbf).sum(2)                 # (B, U)
            sum_m = (mem_b[kc] * nbf).sum(2)
            if sat >= 0:
                occ = used[:, :, sat]
                eff_c, eff_m = eff(occ, cfg.sat_compute), \
                    eff(occ, cfg.sat_memory)
            else:
                eff_c = eff_m = torch.ones(B, U, dtype=f32, device=dev)
            lam = torch.minimum(
                cfg.compute_rate * eff_c / torch.clamp(sum_c, min=_EPS),
                cfg.mem_bw * eff_m / torch.clamp(sum_m, min=_EPS))
            lam = torch.where(occm.any(2), lam, 0.0)
            ttf = torch.where(occm, cfr / lam[:, :, None], torch.inf)
            dt = torch.where(run, ttf.amin((1, 2)), 0.0)
            t = torch.where(run, t + dt, t)
            live = occm & run[:, None, None]
            if work is not None:
                counts["completions"] += int(run.sum())
                counts["unit_events"] += int(live.any(2).sum())
                counts["slot_events"] += int(live.sum())
            cfr = torch.where(live, cfr - lam[:, :, None] * dt[:, None, None],
                              cfr)
            fin = live & (cfr <= _RETIRE_EPS)
            nb_f = torch.where(fin, cnb, 0)
            used = used - (dem[kc] * nb_f.to(f32)[..., None]).sum(2)
            nres = nres - nb_f.sum(2)
            cnb = torch.where(fin, 0, cnb)
            events += run.long()
        check_budget()
    if work is not None:
        work.update(counts)
    return t


def event_times(rows: torch.Tensor, table, *,
                max_events: int | None = None) -> torch.Tensor:
    """rows (B, n) int32/int64 indices into ``table.kernels`` -> (B,)
    float32 makespans on ``rows``' device.  ``max_events`` overrides
    the per-row event budget (tests use it to force an overrun)."""
    if rows.device.type == "cpu":
        return event_times_plain(rows, table, max_events=max_events)
    if rows.device.type != "cuda":
        raise ValueError(f"event_times: no kernel for device {rows.device}")
    refuse_grad("event_times", rows)
    if rows.device.index != torch.cuda.current_device():
        raise ValueError("event_times: rows are not on the current CUDA "
                         "device")
    _check_rows(rows)
    if rows.shape[0] == 0 or rows.shape[1] == 0:
        return torch.zeros(rows.shape[0], dtype=torch.float32,
                           device=rows.device)
    return _launch(rows, table, max_events)


def _launch(rows: torch.Tensor, table, max_events: int | None = None,
            plan: EventPlan | None = None) -> torch.Tensor:
    """The kernel on CUDA ``rows`` (B, n), B, n >= 1, under ``plan``
    (:func:`event_plan`'s where None; the card tests pass the others
    the entry point takes)."""
    nbk, dem, inst_b, mem_b, caps = _device_pack(table, rows.device)
    cfg = config_for_device(table.device)
    B, n = rows.shape
    K, D = dem.shape
    C = cohort_slots(n, _pack_f32(table)[0], cfg.max_resident)
    if bool((_pack_f32(table)[1] < 0).any()):
        raise ValueError("event_times: the kernel takes non-negative "
                         "demands only")
    if plan is None:
        plan = event_plan(K, D, cfg.n_units, C)
    optin = torch.cuda.get_device_properties(
        rows.device).shared_memory_per_block_optin
    if plan.smem > optin:
        raise ValueError(f"event_times: {plan.smem} bytes of shared memory "
                         f"per block (K={K}, U={cfg.n_units}, C={C}) exceed "
                         f"the card's {optin}")
    rows32 = rows.to(torch.int32).contiguous()
    out = torch.empty(B, dtype=torch.float32, device=rows.device)
    err = torch.zeros(1, dtype=torch.int32, device=rows.device)
    rc = library().repro_event_scan(
        rows32.data_ptr(), nbk.data_ptr(), dem.data_ptr(), inst_b.data_ptr(),
        mem_b.data_ptr(), caps.data_ptr(), out.data_ptr(), err.data_ptr(),
        B, n, K, D, cfg.n_units, C, cfg.max_resident, cfg.sat_idx,
        0 if max_events is None else int(max_events),
        cfg.compute_rate, cfg.mem_bw, cfg.sat_compute, cfg.sat_memory,
        F32_FIT_RTOL, _RETIRE_EPS, int(plan.private), plan.width, plan.smem,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"event scan kernel launch failed: CUDA error {rc}")
    event_times.launches += 1
    flags = int(err.item())
    if flags:
        why = [w for bit, w in ((1, "overran its event budget"),
                                (2, "ran out of cohort slots"),
                                (4, "names a kernel outside the table"))
               if flags & bit]
        raise RuntimeError(f"event scan: a row {' and '.join(why)}")
    return out


event_times.launches = 0


def event_times_reference(rows, table) -> np.ndarray:
    """float64 oracle: the port's ``_FastEventSim`` on each row (rows a
    NumPy array or a tensor on any device)."""
    from ..core.refine import _FastEventSim

    if isinstance(rows, torch.Tensor):
        rows = rows.cpu().numpy()
    sim = _FastEventSim(table.device)
    out = np.empty(rows.shape[0], dtype=np.float64)
    for b in range(rows.shape[0]):
        order = [table.kernels[i] for i in rows[b]]
        out[b] = sim.simulate(order)[0]
    return out
