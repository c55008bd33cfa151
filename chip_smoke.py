#!/usr/bin/env python3
"""Chip check of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout,
holds each against its plain PyTorch version on the card, then drives
the port's main path — a dedicated `ScoringSession` scoring the windowed
`lstm` model (W=64, h=64, 1 layer, bf16, random weights from a seed)
over a 32,768-device simulated fleet — and checks its scores. Imports
torch, numpy and `sitewhere_tpu_torch` only.

Phases (a failed phase raises; the script then exits non-zero and
prints no result):
  1. device   — needs CUDA; prints the card's name and power limit;
  2. build    — one nvcc per kernel source, all started together;
  3. kernels  — kernel vs plain at every bucket (atol 2e-3 on the final
                h), median times over CUDA events, cuDNN's LSTM as a
                yardstick, and the card's least time for the same work;
  4. main     — SWB1 encode → decode → store → admit → flush for ~8
                fleet ticks (one with injected anomalies, one flush
                holding duplicate devices, two small flushes); every
                score finite, kernel launches == dispatches, a sample of
                each flush against the plain kernel version (atol 1e-2
                plus 1e-3 relative for the float16 readback), anomalies
                above the normal p99.
The second-to-last line is the `{"kernels": [...]}` record; the last is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import asyncio
import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
BUCKETS = (256, 1024, 4096, 16384)
WINDOW, HIDDEN = 64, 64
FLEET = 32768
# published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor rate
# and HBM bandwidth; the card's own power limit is printed beside them
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
KERNEL_ATOL = 2e-3
SCORE_ATOL, SCORE_RTOL = 1e-2, 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    # a float32 reference runs in full float32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.cuda.get_device_name(0)


def phase_build() -> None:
    from sitewhere_tpu_torch.ops.build import build_all

    t0 = time.perf_counter()
    reports = build_all()
    log(f"build: {len(reports)} kernel source(s) in "
        f"{time.perf_counter() - t0:.3f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def cuda_median_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def lstm_bound_ms(batch: int, steps: int, hidden: int) -> tuple[float, str]:
    flops = 2.0 * batch * steps * (1 + hidden) * 4 * hidden
    nbytes = (batch * steps * 4            # xn in (f32)
              + 4 * hidden * 2             # wx (bf16)
              + hidden * 4 * hidden * 2    # wh (bf16)
              + 4 * hidden * 4             # b (f32)
              + batch * hidden * 4)        # final h out (f32)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def library_lstm_ms(torch, layer: dict, xn) -> float:
    """One cuDNN `torch.nn.LSTM` call on the same inputs (same i/f/g/o
    gate order), a yardstick only — the port never calls it."""
    hidden = layer["wh"].shape[0]
    lstm = torch.nn.LSTM(1, hidden, batch_first=True).to(xn.device)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(layer["wx"].T)
        lstm.weight_hh_l0.copy_(layer["wh"].T)
        lstm.bias_ih_l0.copy_(layer["b"])
        lstm.bias_hh_l0.zero_()
    lstm = lstm.to(torch.bfloat16)
    lstm.flatten_parameters()  # one weight chunk: no compaction per call
    seq = xn[:, :, None].to(torch.bfloat16).contiguous()
    with torch.no_grad():
        return cuda_median_ms(torch, lambda: lstm(seq), reps=10)


def phase_kernels(torch) -> list[dict]:
    from sitewhere_tpu_torch.models import build_model
    from sitewhere_tpu_torch.ops.lstm_kernel import (
        lstm_window_final,
        lstm_window_final_plain,
    )

    model = build_model("lstm", window=WINDOW, hidden=HIDDEN)
    layer = model.init(torch.Generator().manual_seed(SEED))["lstm0"]
    gen = torch.Generator().manual_seed(SEED + 1)
    rows = []
    for batch in BUCKETS:
        # the main path hands the kernel xn[:, :-1] of a [B, W] window
        xw = torch.randn((batch, WINDOW), generator=gen).cuda()
        xn = xw[:, :-1]
        got = lstm_window_final(layer, xn, torch.bfloat16)
        want = lstm_window_final_plain(layer["wx"], layer["wh"], layer["b"], xn)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not err < KERNEL_ATOL:
            raise AssertionError(f"kernel vs plain at B={batch}: "
                                 f"max |err| {err} >= {KERNEL_ATOL}")
        ms = cuda_median_ms(
            torch, lambda: lstm_window_final(layer, xn, torch.bfloat16), reps=50)
        plain_ms = cuda_median_ms(
            torch, lambda: lstm_window_final_plain(
                layer["wx"], layer["wh"], layer["b"], xn), reps=5, warmup=1)
        lib_ms = library_lstm_ms(torch, layer, xn.contiguous())
        bound_ms, bound_by = lstm_bound_ms(batch, WINDOW - 1, HIDDEN)
        row = {"batch": batch, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"lstm_window_final B={batch}: {json.dumps(row)}")
        rows.append(row)
    return rows


def plain_scores(torch, model, params, x, valid):
    """`score_fused` with the kernel's plain version in place of the
    kernel, on the same ring windows."""
    from sitewhere_tpu_torch.ops.lstm_kernel import lstm_window_final_plain

    layer, head = params["lstm0"], params["head"]
    xn, _, _ = model._normalize(x, valid.float())
    h = lstm_window_final_plain(layer["wx"], layer["wh"], layer["b"],
                                xn[:, :-1])
    pred = (h @ head["w"] + head["b"])[:, 0]
    return model._finalize(pred, xn, valid)


async def phase_main(torch) -> dict:
    from sitewhere_tpu_torch.domain.batch import BatchContext, MeasurementBatch
    from sitewhere_tpu_torch.kernel.metrics import MetricsRegistry
    from sitewhere_tpu_torch.models import build_model
    from sitewhere_tpu_torch.ops import lstm_kernel
    from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore
    from sitewhere_tpu_torch.scoring.server import ScoringConfig, ScoringSession
    from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig

    t_setup = time.perf_counter()
    model = build_model("lstm", window=WINDOW, hidden=HIDDEN)
    store = TelemetryStore(history=128, initial_devices=FLEET)
    sim_cfg = SimConfig(num_devices=FLEET, seed=SEED)
    sim = DeviceSimulator(sim_cfg, tenant_id="smoke")
    for k in range(WINDOW + 4):
        store.append_measurements(sim.tick(t=60.0 * k)[0])
    metrics = MetricsRegistry()
    session = ScoringSession(
        model, store, metrics,
        ScoringConfig(buckets=BUCKETS, capacity=FLEET))
    session.warmup()
    torch.cuda.synchronize()
    log(f"main: set-up (store fill + warmup) "
        f"{time.perf_counter() - t_setup:.3f} s")

    t = 60.0 * (WINDOW + 4)
    plan = []  # (label, [(batch, truth)], anomaly tick?)
    for k in range(6):
        plan.append(("fleet", [sim.tick(t=t + 60.0 * k)], False))
    t += 60.0 * 6
    sim.cfg = SimConfig(num_devices=FLEET, seed=SEED, anomaly_rate=0.05,
                        anomaly_magnitude=12.0)
    plan.append(("anomalies", [sim.tick(t=t)], True))
    sim.cfg = sim_cfg
    dup = np.arange(3000, dtype=np.uint32)
    plan.append(("duplicates", [sim.tick(t=t + 30.0, devices=dup),
                                sim.tick(t=t + 45.0, devices=dup)], False))
    plan.append(("small-256", [sim.tick(t=t + 60.0, devices=np.arange(
        200, dtype=np.uint32))], False))
    plan.append(("small-1024", [sim.tick(t=t + 60.0, devices=np.arange(
        5000, 5900, dtype=np.uint32))], False))

    dispatches = metrics.counter("scoring.dispatches")
    d0 = dispatches.value
    lstm_kernel.launches = 0
    rng = np.random.default_rng(SEED)
    flush_ms, host_ms, n_events, busy_s = [], [], 0, 0.0
    for label, ticks, anomalous in plan:
        t0 = time.perf_counter()
        for batch, _ in ticks:
            payload = batch.encode()
            wire = MeasurementBatch.decode(
                payload, BatchContext(tenant_id="smoke", source="gateway"))
            store.append_measurements(wire)
            session.admit(wire)
        t1 = time.perf_counter()
        scored = await session.flush()
        t2 = time.perf_counter()
        busy_s += t2 - t0
        flush_ms.append(1e3 * (t2 - t1))
        host_ms.append(1e3 * (t1 - t0))
        n = sum(len(b) for b, _ in ticks)
        n_events += n
        if len(scored) != n or not np.isfinite(scored.score).all():
            raise AssertionError(f"{label}: {len(scored)} scores for {n} "
                                 f"events, finite={np.isfinite(scored.score).all()}")
        # the newest occurrence of each device scored the ring's current
        # window: score a sample of those through the plain version
        dev = scored.device_index
        _, rev = np.unique(dev[::-1], return_index=True)
        newest = dev.shape[0] - 1 - rev
        sample = rng.choice(newest, size=min(512, newest.shape[0]),
                            replace=False)
        x, valid = session.ring.windows(dev[sample])
        ref = plain_scores(torch, model, session.params, x, valid)
        ref = ref.to(torch.float16).float().cpu().numpy()
        err = np.abs(scored.score[sample] - ref)
        if not (err <= SCORE_ATOL + SCORE_RTOL * np.abs(ref)).all():
            raise AssertionError(f"{label}: scores vs plain, max |err| "
                                 f"{err.max()}")
        log(f"main: flush {label}: {n} events in {flush_ms[-1]:.3f} ms, "
            f"sample max |err| vs plain {err.max():.3e}")
        if anomalous:
            truth = ticks[0][1]
            a_med = float(np.median(scored.score[truth]))
            n_p99 = float(np.quantile(scored.score[~truth], 0.99))
            log(f"main: anomalies {int(truth.sum())}: median score {a_med}, "
                f"normal p99 {n_p99}")
            if not a_med > n_p99:
                raise AssertionError("injected anomalies do not stand out")
    launches = lstm_kernel.launches
    n_dispatch = int(dispatches.value - d0)
    if launches == 0 or launches != n_dispatch:
        raise AssertionError(f"kernel launches {launches} != dispatches "
                             f"{n_dispatch}")
    await session.drain()
    stats = {"events": n_events, "flushes": len(flush_ms),
             "dispatches": n_dispatch, "events_per_s": n_events / busy_s,
             "flush_p50_ms": float(np.quantile(flush_ms, 0.5)),
             "flush_p99_ms": float(np.quantile(flush_ms, 0.99)),
             "host_ms_per_flush_p50": float(np.quantile(host_ms, 0.5)),
             "kernel_launches": launches}
    log(f"main: {json.dumps(stats)}")
    return stats


def main() -> int:
    import torch

    kind = phase_device(torch)
    phase_build()
    rows = phase_kernels(torch)
    stats = asyncio.run(phase_main(torch))
    top = rows[-1]  # the main path's full flushes run at the largest bucket
    kernels = [{
        "name": "lstm_window_final",
        "route": "cuda",
        "source": "sitewhere_tpu_torch/csrc/lstm_window.cu",
        "replaces": "sitewhere_tpu/ops/lstm_kernel.py:75",
        "launches": stats["kernel_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "shape": {"batch": top["batch"], "steps": WINDOW - 1,
                  "hidden": HIDDEN},
        "per_bucket": rows,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
