#!/usr/bin/env python3
"""Chip check of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout,
holds each against its plain PyTorch version on the card, then drives
each of the port's serving paths at full width (W=64, h=64, 1 layer,
bf16, random weights from seeds, a 32,768-device simulated fleet; the
other models at the widths the repo configures for them), its training
plane and its CLI, and checks what each returns. Imports torch, numpy, `sitewhere_tpu_torch` and, for the TFT's bit-equality check, the benchmark's plain reference `swxbench/reference/tft.py`.

Phases (a failed phase raises; the script then exits non-zero and
prints no result):
  1. device   — needs CUDA; prints the card's name and power limit;
  2. build    — one nvcc per kernel source, all started together;
  3. kernels  — kernel vs plain at every bucket at h=64 and at
                h in {8, 16, 32} (atol 2e-3 on the final h); `ms` is one
                wrapper call between CUDA events (host cost included),
                timed as the plain version and cuDNN's LSTM (a yardstick)
                are; `graph_ms` is the kernel's device time per launch
                (a CUDA graph of back-to-back launches); `bound_ms` the
                card's least time for the same work;
  3b. stream-kernel — K2 (the streaming step, `ops/lstm_stream_kernel.py`)
                against its plain chain on the card at every bucket, one
                tenant (float16 scores, as served) and four stacked
                (float32 scores; one row partly filled, one slot empty:
                scratch padding), and one tenant at B=4096 with bfloat16
                scores; 256 consecutive steps on the same rows so that
                the recurrence's drift shows; max |Δscore| / max(1,
                |plain's float32 score|) held to STREAM_KERNEL_TOL plus
                the score type's rounding, |Δh|, |Δc| and |Δpred| to
                STREAM_STATE_TOL, the Welford stats and the count equal,
                one launch a step; `ms`, `graph_ms`, the plain chain's
                ms, the wrapper's input checks alone (`check_ms`), the
                host ms of a ring dispatch with each, and the byte bound;
  3c. tft-fused — K3 (the TFT forward's pointwise work and its
                dense layers' products,
                `ops/tft_fused.py`): the order probe (cuBLAS's float32
                product against `tft_fused.probe`, the k-ascending sum, at
                every product shape of the forward, buckets 256–16,384,
                vmapped and not, bf16 and float16 operands with spread
                exponents: equal wherever `tft_fused.fits` takes the shape);
                each fused product through `OPS` against `PLAIN` (cuBLAS
                and the plain epilogue), vmapped and not, bf16 and float16,
                aligned and not, and at `TftConfig`'s defaults; each of its
                kernels against its plain
                version at the electricity widths' 16,384-row shapes, on
                inputs with zeros, negatives, large magnitudes and bf16
                ties, bit for bit (and in float16 at a smaller shape);
                `ms`, `graph_ms`, the plain version's ms and the byte
                bound; then the TFT's one stage code through the op table
                `OPS` against the same code through `PLAIN`, each stage
                (`tft.select`, `tft.seq2seq`, `tft.attend`) and the
                scores, and against the benchmark's reference
                (`swxbench/reference/tft.py`, imported, never edited) at
                buckets 256, 1,024, 4,096 and 16,384, vmapped over one
                stacked tenant and not: every value equal; the same at
                `TftConfig`'s defaults; device operations, K3 launches and
                fused products a forward through each table, and the host's
                enqueue and the device time of a 16,384-row forward (the
                `pool-tft` phase holds `tft_fused.product_launches` to its
                dispatches × the fused products a forward);
  4. main     — SWB1 encode → decode → store → admit → flush for ~8
                fleet ticks (one with injected anomalies, one flush
                holding duplicate devices, two small flushes); every
                score finite, kernel launches == dispatches, a sample of
                each flush against the plain kernel version (atol 1e-2
                plus 1e-3 relative for the float16 readback), anomalies
                above the normal p99;
  5. stream   — the main phase's plan through a dedicated session on the
                streaming `lstm-stream` model (the default serving
                model); then a second such session with
                readback="anomalies" scores the same anomaly tick;
  6. pool     — `SharedScoringPool` on `lstm-stream`: 1 tenant × 32,768
                devices with one fleet-sized bucket (the bench's default)
                and 8 tenants × 4,096 devices with their own weights and
                bucket 4096 (the bench's megabatch A/B shape), four fleet
                ticks and an anomaly tick each;
  7. pool-window — the pool on the windowed `lstm`, 4 tenants × 8,192
                devices, a fleet tick and an anomaly tick;
  8. pipeline-stream — the bench's default deployment through the
                service runtime (`tools/pipeline.py`): six services, one
                tenant of 32,768 devices, `lstm-stream` through the pool,
                fast lane and egress engaged; six fleet ticks (one with
                anomalies) submitted to the tenant's receiver. Every event
                lands on the scored topic exactly once, telemetry counts
                them, the inbound group commits to the decoded topic's
                end, a sample agrees with the CPU reference, K1 launches
                0; prints events/s (first submit → last scored record),
                `scoring.e2e_latency_s` p50/p99 of that burst (queue
                depth) and of 24 more ticks paced at half the burst's
                rate (the bench's latency reading), dispatches and the
                stages' host time;
  9. pipeline-window — the same pipeline on the windowed `lstm` with
                megabatch off (a dedicated session: K1 inside the
                runtime); K1 launches == dispatches, the ring's windows
                equal the store's, and a sample of the last tick agrees
                with K1's plain version on the store's windows; then the
                same paced window;
 10. demo     — `python -m sitewhere_tpu_torch.cli demo --devices 4096
                --seconds 3 --port P` on the card (all fourteen services):
                events persisted == sent, model alerts > 0, and while it
                runs `GET /api/instance/health` on P answers 200 with the
                fourteen services;
 11. native   — the telemetry store's host library (g++, built in phase
                2) at 32,768 devices × history 256: six 32,768-event ticks
                with in-batch duplicates and ring wraparound, the library
                bit-equal to its numpy plain versions for append, window,
                window_ts and latest; ms per append and per window for both;
 12. pool-tft — the pool on `tft` at `TftConfig`'s defaults (W=64, H=8,
                d=32, 4 heads, 3 quantiles, bf16: the bench's `--model
                tft`), one tenant of 32,768 devices with one fleet-sized
                bucket: a fleet tick and an anomaly tick;
 13. pool-longwin — the same on `longwin` as the bench runs it
                (`--window 64`, d=32, 4 heads, 2 layers);
 14. longwin-512 — `longwin` at its default window of 512 on a dedicated
                session over 8,192 devices, buckets 256 and 1,024 (one
                1,024-row dispatch holds 4.3 GB of attention scores): two
                fleet ticks and an anomaly tick, the ring's windows equal
                to the store's; phases 13 and 14 then run again with the
                model in float32 (pool-longwin-...-float32,
                longwin-512-float32);
 15. seasonal — the pool on `seasonal` at its defaults (W=32, H=6), 4
                tenants × 4,096 series: a fleet tick and an anomaly tick
                (the score is a forecast: no anomaly bar);
 16. forecast — `forecast_device(include_attention=True)` on a `tft`
                tenant of the service runtime, eight devices, forecasts
                and [heads, H, W] attention against the CPU model;
 17. maintenance — the bench's GNN fleet (n/50 assets, n/200 areas under
                one site) at 10,000 and 32,768 devices: graph build,
                `MaintenanceTrainer.train` at its defaults (200 AdamW
                steps), then risk scores per second (the bench's
                `gnn_fleet_risk_scores_per_sec`), the risks against the
                CPU;
 18. pipeline-durable — phase 8 with `data_dir` on a fresh directory (the
                bench's `--durable`): burst events/s, persist ms a tick,
                the spill log's written/dropped; then the runtime stops
                and a fresh one starts on the directory: seconds from
                start to ready (time to recover), the registry's
                `restored_from`, every written event back in the store in
                the first runtime's order, and one more tick scored and
                sampled against the CPU reference;
 19. replay   — the bench's replay corpus (500,000 events over 32,768
                devices, 60 s windows, blocks of 65,536) compacted into
                the cold tier and replayed by `ReplayEngine` through a
                `SharedScoringPool` on the card (`lstm-stream`, buckets
                256/1024/4096/8192): one checked pass (every event scored
                exactly once, a 1,024-device sample against the CPU
                streaming model fed the same records from a cold state),
                then timed passes; replay and compaction events/s;
                `guard_swap` over the corpus promotes identical params and
                refuses perturbed ones (over all of it: one window holds
                ≈2 events a device, below the model's scoring floor);
 20. cli-replay — `python -m sitewhere_tpu_torch.cli replay --data-dir
                <phase 18's directory> --tenant bench` on the card: exit 0,
                as many events replayed and scored as the durable log
                holds;
 21. train    — `python -m sitewhere_tpu_torch.cli train --model
                lstm-stream --checkpoint DIR` at the CLI's defaults (1,024
                series of 192 points, W=64, batch 1,024, 200 Adam steps):
                steps/s and the final loss;
 22. replay-candidate — `cli replay --model lstm-stream --candidate DIR`
                on phase 18's directory: the exit code agrees with the
                reported divergence against the bar (0 promoted, 1
                refused);
 23. ingress  — phase 8's deployment again, fed through every ingress of
                the port: one receiver of each protocol (mqtt, websocket,
                coap, amqp, stomp) added to the tenant and a Kafka endpoint
                on the runtime's bus. The gateway pattern: 16 clients a
                protocol, each carrying a fixed slice of 2,048 devices
                (≈36.9 KB of SWB1 a message) on its own topic, routing
                key, destination or partition; six fleet ticks (one with
                anomalies) a protocol, the protocols one after another,
                each sent as the port's `sim/clients` senders send it
                (coap: confirmable requests through `coap_post`, 4 in
                flight; kafka: Produce v0 of codec-encoded batches to the
                tenant's decoded topic). Each protocol is held as phase 8
                is (every event once, telemetry, committed offsets,
                finite scores, anomalies, a 1,024-device sample of every
                tick against the CPU reference, K1 launches 0) with
                dispatches ≥ ticks; it prints events/s, the burst's e2e
                p50/p99 (from the receiver's socket edge), the clients'
                send time and the stages' host ms; mqtt also runs the
                paced window through its gateways; then the WebSocket
                listener's frame read (its per-byte unmask) is timed on
                one gateway message, 16 NON gateway messages from the
                port's `CoapSender` go at once to a bare CoAP listener
                (how many arrive is printed), and `python -m
                sitewhere_tpu_torch.cli simulate --protocol mqtt` runs
                against the live runtime: exit 0, the events it reports
                sent are the events decoded from its topic and persisted;
 24. ingress-window — the same 16 MQTT gateways into phase 9's windowed
                `lstm` on a dedicated session: K1 launches == dispatches
                > 0, the ring's windows equal the store's, and a sample
                of the last tick agrees with K1's plain version;
 25. platform — the fourteen-service runtime (`cli.ALL_SERVICES`, REST
                on port 0, a `data_dir` under build/) driven through its
                REST socket by a raw asyncio HTTP client: a request
                without a JWT answers 401, `POST /api/jwt` issues one;
                `POST /api/tenants` creates the bench's windowed `lstm` at
                full width on a dedicated session with one geofence, an
                MQTT receiver and MQTT command delivery; 32,768 devices
                come in through `bootstrap_fleet` (areas of 256 under one
                site); 300 devices are created and read back over REST on
                a second tenant (p50/p99 ms a request); W+4 fleet ticks go
                through the queue receiver (K1 launches == dispatches);
                `POST /api/batch/train` (lstm, 100 steps, batch 1,024),
                polled through `GET /api/batch/{id}`: finished,
                hot-swapped, checkpoint version 1, finite losses falling,
                the session's version bumped once (steps/s and the event
                loop's stall are printed); two more ticks: K1 launches ==
                dispatches, a 1,024-device sample against the CPU model on
                the checkpoint's params read back through
                `CheckpointStore`, and at least half of it moved from the
                pre-swap weights' scores; `POST /api/zones`, then three
                location ticks moving 4,096 seeded devices in and out:
                the zone.enter / zone.exit alerts equal numpy
                `points_in_polygon`'s prediction; the GNN sweep through
                `submit_maintenance_operation` (every 97th device an
                incident): finished, its risks within 1e-5 of the CPU
                model on its checkpoint and graph, devices at risk == the
                alerts it raised (risk scores/s printed); an MQTT client
                of one device subscribes to its command topic, `POST
                .../invocations` reaches it, its response `POST`ed back
                shows in `GET /api/invocations/{id}/responses` (the round
                trip in ms);
 26. split-window — the bench's process split (`tools/split.py`,
                `bench.py --split`) at 32,768 devices: the broker (an
                in-proc bus behind a `BusServer`), event-sources and the
                simulator in this process, device-management,
                inbound-processing, event-management, device-state and
                rule-processing (pipeline-window's tenant: K1 on a
                dedicated session) in a fresh interpreter on a
                `RemoteEventBus`; W+4 warm ticks into its store, six fleet
                ticks, then 24 paced at half the burst's rate. Every event
                scored exactly once (read back over the broker), every
                consumer group of the tenant committed through the end
                offsets, finite scores, anomalies standing out, K1 launches
                == dispatches in the scorer process, and a 1,024-device
                sample against K1's plain version on the CPU over the
                scorer's params and store windows (written under build/);
                prints events/s, the scorer's e2e p50/p99 (wire decode →
                scored) and its stage breakdown, `wire_stats()`,
                dispatches and K1 launches;
 27. split-stream — the same with `lstm-stream` through the pool: K1
                launches 0, the sample against the CPU streaming model
                stepped over every tick;
 28. cli-split — `cli serve-bus --port 0`, `cli run --bus` hosting the
                five scoring services with `--no-tenants` and an
                `--api-port` (on the card), `cli run --bus --services
                event-sources` with the default tenant and a TCP gateway;
                2,048 devices registered over the API port, `cli
                simulate` at the gateway for 2 s: every event sent is
                persisted in the scoring process (read back over its API
                port), and SIGTERM stops all three with exit 0;
 29. fleet-window — the bench's fleet (`tools/fleet.py`, `bench.py
                --workers 2`): the broker, event-sources, the controller
                and the simulator in this process, two worker processes on
                the card hosting the five scoring services for 4 tenants
                × 8,192 devices (pipeline-window's windowed `lstm`, K1 on
                each tenant's session), registries adopted by bus replay,
                the tenants placed while the workers start (as the bench
                does: the second worker's placement moves some); W+4 warm
                ticks and six burst ticks: every event scored
                once, the anomalous tick standing out, K1 launches ==
                dispatches in each worker (its `stats` op), 1,024 devices
                against K1's plain version on windows built from the ticks
                sent; then a 6 s flood with the busiest worker SIGKILLed:
                0 accepted events lost, the decoded backlog 0, every
                tenant group committed through the end, the death detected
                within the 6 s bound (plus the polling step), the
                replacement in; prints events/s and the seconds to detect,
                reassign, converge and take the replacement in;
 30. fleet-forecast — the controller's predictive planner on a runtime
                with a telemetry history: synthetic ramp history,
                `seasonal` trained and checkpointed, tenant-0 served
                through the pool on the card until the controller's
                `autoscale()` records a forecast-attributed `add_replica`
                with its provenance; the slot's store windows equal to the
                lag appended, the forecasts against the CPU model on the
                checkpoint's weights over those windows;
 31. cli-fleet — `cli run --fleet-controller --serve-bus-port 0` (REST,
                the default tenant, a TCP gateway), 2,048 devices
                registered onto the broker's bus, two `cli fleet-worker`
                processes on the card, `cli fleet status` until adopted,
                `cli simulate` for 2 s, SIGKILL of the tenant's owner,
                `fleet status` until the survivor owns it, `cli simulate`
                again: every event sent persisted (the event-management
                group committed through the end, every (device, time) on
                the persisted topic), SIGTERM stops the rest with exit 0.
 32. bench    — `cli bench` (`tools/bench.py`, every mode of `bench.py`)
                in fresh interpreters at full width with short windows:
                the default run (`lstm-stream` in the pool), `--model lstm
                --no-megabatch` (K1 on dedicated sessions: `pallas` cuda,
                K1 launches == dispatches over the measured phases),
                `--replay` (500,000 events, all scored each pass),
                `--workers 2 --zombie-drill --no-fleet-kill` (0 lost, 0
                committed twice, the zombie fenced; the kill drill is phase
                29's and the ramp's), `--overload` (the hog shed, the others
                keeping their goodput), `--chaos` (faults injected, every
                drain complete), `--ramp` (reduced seed and ramp seconds;
                drained, its kill drill losing 0); each report on `gpu`
                with the card's name, events/s > 0 and 0 < mfu <= 1 where
                the model counts its FLOPs; then a `tools/ab_compare.py
                fastlane` pair; one stats line a run. Also `--mesh 4x2`
                (bench-mesh): on one card the reference's degrade, the
                report's `scoring.mesh` `shape` null and `devices` 0 with
                the logged warning (with more cards, the fit to them);
 33. lint     — the port's swxlint over the port (host only): no new
                finding, no stale or reasonless baseline entry; counts by
                code and each checker's seconds;
 34. mesh-pool — the pool at the bench's megabatch shape (8 tenants ×
                4,096 devices, `lstm-stream`) twice, four fleet ticks
                each: over an explicit `{data: 2, model: 2}` mesh (cuda:0
                repeated; distinct cards where there are more), then
                meshless; every event scored once, the meshed scores held
                to the meshless run's (atol 1e-2 plus 1e-3 relative,
                float16 readback), `mesh_stats()` reporting 4 devices;
                wall time and flush p50/p99 of both;
 35. ring     — `ring_attention_sharded` at longwin-512's width (W=512,
                d=32, 4 heads, B=1,024, causal, a random validity mask)
                over a 4-way `seq` axis, against `dense_attention` (f32
                inputs 2e-5; bf16 inputs 2e-3); then `LongWindowModel`
                at W=512 sequence-parallel over the same axis against the
                meshless model on 1,024 rows (f32: quantile outputs 1e-4
                and the loss 1e-5 relative; bf16: 99.9% of the outputs
                within 1e-2, the loss 1e-3 relative);
 36. train-dp — `Trainer` at the CLI's `lstm` (W=64, h=64, batch 1,024)
                with `data: 2` against meshless for 5 steps on the same
                batches, losses printed and held (1e-3 relative), then
                `cli train --distributed` as one nccl process (world size
                1) through the SWX_* contract. Two ranks cannot share one
                card under nccl: the two-process lockstep is a CPU test
                (`tests/test_torch_distributed.py`), and the phase says so.
Phases 5–8 and 12–15 check that every event is scored, every score
finite, the dispatches are the occurrence rounds, injected anomalies
stand out (lstm, lstm-stream and tft; untrained longwin scores ordinary
points at the clip, and seasonal's score is a forecast), and a sample of
1,024 devices per tenant agrees with an independent CPU reference (the
streaming model stepped over the same events from its host windows, or
the model's `score` on the host store's windows; atol 1e-2 plus 1e-3
relative); they print the host milliseconds of each dispatch. `longwin`
(phases 13–14) divides its score by a predicted interval's width, which
untrained weights make narrow, so a bf16 ulp that lands differently on
the CPU moves a few rows' score past any tolerance: its bf16 sample is
held in aggregate (a floor on the share of rows within the tolerance, a
ceiling on the p99 |err|: BF16_SHARE_FLOOR), and the same served paths
in float32 hold every sampled row to the tolerance. K1 runs on none of
these paths, so its launch count must stay 0 there, and in phases 18–19,
23 and 27; on `lstm-stream` every dispatch launches K2 once (the
wrapper's `launches` == dispatches, and `scoring.stream_kernel_dispatches`
follows it), on the other models never. Each path prints one stats line.
The second-to-last line is the `{"kernels": [...]}` record; the last is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import asyncio
import json
import math
import os
from collections import Counter
import re
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

from sitewhere_tpu_torch.sim.simulator import SimConfig
from sitewhere_tpu_torch.tools.main_path import (
    BUCKETS,
    FLEET,
    HIDDEN,
    SEED,
    THRESHOLD,
    TICK_S,
    WINDOW,
)

# the other widths the repo configures, checked at one ragged batch
WIDTHS, WIDTH_BATCH = (8, 16, 32), 1000
# K1's `ms` with its earlier CUDA-core design, logged beside this run's
# (chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W)
CUDA_CORE_MS = {256: 0.121, 1024: 0.291, 4096: 0.484, 16384: 1.486}
# published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor rate
# and HBM bandwidth; the card's own power limit is printed beside them
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
# the float32 rate outside the tensor cores, where the TFT's products run
PEAK_F32_FLOPS = 67e12
KERNEL_ATOL = 2e-3
# K2 against its plain chain on the card, max |Δscore| / max(1, |plain|)
# over 256 steps: the two differ only in the order of the h·wh sum (tensor
# cores against a float32 GEMM) before its bf16 rounding and of the
# head's sum, so a gate may round one bf16 ulp apart and the state drift
# a little; held well under the benchmark's `score_gap` limit (0.012),
# near the largest gap sound pool runs gave against the reference
# (0.00345)
STREAM_KERNEL_TOL = 4e-3
# K2 writes its float32 score narrowed to the ring's score type, held to
# the plain chain's float32 score: the narrowing adds up to half an ulp,
# 2**-11 of max(1, |score|) in float16 and 2**-8 in bfloat16
SCORE_ROUNDING = {"float32": 0.0, "float16": 2.0 ** -11,
                  "bfloat16": 2.0 ** -8}
# K2's state against the plain chain's after the same 256 steps, max |Δ|:
# four times the largest gap measured over every bucket and T (2.79e-3,
# 3.90e-3, 7.9e-4 on an NVIDIA H100 80GB HBM3 at 700 W), the order of the
# sums being all that differs; the Welford stats and the count take no
# product, so they must come out equal
STREAM_STATE_TOL = {"h0": 1.2e-2, "c0": 1.6e-2, "pred": 3.2e-3}
STREAM_EXACT = ("mean", "var", "count")
STREAM_STEPS, STREAM_TENANTS = 256, (1, 4)
# one tenant at one bucket with bfloat16 scores (the ring's other 16-bit
# score type)
STREAM_BF16 = (1, 4096)
SCORE_ATOL, SCORE_RTOL = 1e-2, 1e-3
# K3 (ops/tft_fused.py) at the benchmark's TFT: the electricity widths
# (swxbench/configs/tft-electricity-32k.json), its buckets and the rows of
# the kernels' shapes (a bucket's worth of context steps); the float16
# kernels are checked at a smaller row count
TFT_WIDTHS = {"window": 192, "horizon": 24, "hidden": 160, "heads": 4}
TFT_BUCKETS, TFT_ROWS, TFT_F16_ROWS = (256, 1024, 4096, 16384), 16384, 512
# the dense layers' products (K, N) by the rows a window gives them, at the
# electricity widths (d = 160) and at `TftConfig`'s defaults (d = 32): one
# row a window (the static GRN), the context's steps (the past selection),
# the horizon's (the future selection, the attention's query, output and
# tail) and the whole window's (enrichment, key, value);
# the order probe holds cuBLAS to the k-ascending sum at each, at every
# bucket (the defaults' also at the pool's fleet-sized 32,768), vmapped
# and not, in bfloat16 and float16
TFT_PRODUCTS = {
    "electricity": {1: [(160, 160)],
                    168: [(640, 160), (160, 160)],
                    24: [(320, 160), (160, 160), (40, 160)],
                    192: [(160, 160), (160, 40)]},
    "defaults": {1: [(32, 32)],
                 56: [(128, 32), (32, 32)],
                 8: [(64, 32), (32, 32), (8, 32)],
                 64: [(32, 32), (32, 8)]},
}
TFT_PROBE_BUCKETS = {"electricity": TFT_BUCKETS,
                     "defaults": (*TFT_BUCKETS, 32768)}
# the probe's operands: bf16 (float16) values with exponents spread over
# 2^-20 … 2^20 (2^-11 … 2^11), so that any other order of the sum shows
TFT_PROBE_SPAN = {0: 20, 1: 11}
# `longwin` divides its score by a predicted interval's width, which
# untrained weights make narrow: where the card and the CPU round a
# quantile a bf16 ulp apart, a row's score moves past any row tolerance
# (by up to 7.06 at window 512 on an NVIDIA H100 80GB HBM3 at 700 W, while
# float32 agrees to 1e-3). So its bf16 sample is held by window to a
# floor on the share of rows within the tolerance and a ceiling on the
# p99 |err| (readings on that card: 99.2% and 8.8e-3 at 64, 97.8% and
# 0.089 at 512), and the same served path runs again in float32 with every
# sampled row held to the tolerance.
BF16_SHARE_FLOOR = {"longwin": {64: (0.985, 0.015), 512: (0.97, 0.12)}}
# the forecast's attention weights (≈1/56 each over the context; reading
# 4.3e-4) and the GNN's float32 risks (reading 1.8e-7) against the CPU
ATTN_ATOL, RISK_ATOL = 1e-3, 1e-5
# devices per tenant held against the CPU reference in phases 5–7
SAMPLE = 1024
# (tenants, devices a tenant, buckets) of the pooled phases
POOLS = ((1, FLEET, (FLEET,)), (8, FLEET // 8, (FLEET // 8,)))
WINDOW_POOL = (4, FLEET // 4, (FLEET // 4,))
# fleet ticks through the service runtime, and the anomalous one
PIPELINE_TICKS, PIPELINE_ANOMALY_AT = 6, 3
# then the latency window: ticks offered at this share of the burst's rate
PACED_TICKS, PACED_FRACTION = 24, 0.5
# the ingress phases: gateway clients a protocol (each a fixed slice of
# FLEET / GATEWAYS devices: 2,048, ≈36.9 KB of SWB1 a message, under one
# CoAP datagram), the protocols in the order they run, CoAP requests in
# flight at once, and the devices of the `cli simulate` run
GATEWAYS = 16
INGRESS_PROTOCOLS = ("mqtt", "websocket", "coap", "amqp", "stomp", "kafka")
COAP_INFLIGHT = 4
SIMULATE_DEVICES = 2048
# the native store phase: ring length and ticks
NATIVE_HISTORY, NATIVE_TICKS = 256, 6
# timed passes over the bench's replay corpus (tools/replay_bench.py), and
# the shadow gate's bar
REPLAY_TRIALS, GATE_BAR = 3, 0.05
# the other models: longwin at window 512 (devices, buckets); seasonal's
# pool (tenants, series a tenant); the forecast queries (fleet, queries);
# the maintenance fleets and their scoring loop's seconds
LONGWIN_FLEET, LONGWIN_BUCKETS = 8192, (256, 1024)
SEASONAL_POOL = (4, 4096, (4096,))
FORECAST_FLEET, FORECAST_QUERIES = 4096, 8
MAINT_SIZES, MAINT_SECONDS = (10000, 32768), 2.0
# the platform phase: the scored tenant's fleet and its areas' size, the
# devices created and read back over REST on a second tenant, the
# training operation's steps and batch, the devices the geofence moves,
# and the loop probe's period
PLATFORM_FLEET, PLATFORM_AREA = FLEET, 256
PLATFORM_REST_DEVICES = 300
PLATFORM_TRAIN_STEPS, PLATFORM_TRAIN_BATCH = 100, 1024
PLATFORM_GEO_SUBSET = 4096
PROBE_S = 0.005
# the fleet-window phase: the slack allowed past `fleet_dead_after_s`
# for the controller's tick and this process's polling
FLEET_POLL_SLACK_S = 0.5
# the bench phase: `cli bench` runs at the bench's full width (32,768
# devices, W=64, h=64, bf16) with short windows, each with its name, its
# flags and its time limit in seconds. The runs of a lane go one after
# another and the lanes side by side, to keep the script inside its time
# budget (the fleet runs spend most of their time waiting out death bounds
# and worker start-ups), so each run's numbers are taken beside the other
# lanes' load; the A/B pair runs last, alone
BENCH_SHORT = ("--seconds", "3", "--sat-trials", "2", "--latency-seconds",
               "3")
BENCH_RUNS = {
    "default": (BENCH_SHORT, 240),
    "window": (BENCH_SHORT + ("--model", "lstm", "--no-megabatch"), 240),
    "replay": (("--replay", "--sat-trials", "2"), 240),
    # the kill drill is phase 29's and the ramp's: here the zombie drill
    "workers": (("--workers", "2", "--zombie-drill", "--no-fleet-kill",
                 "--seconds", "3", "--sat-trials", "1"), 420),
    "overload": (("--overload", "--seconds", "3"), 240),
    "chaos": (("--chaos", "--seconds", "3", "--sat-trials", "1",
               "--latency-seconds", "2"), 240),
    "ramp": (("--ramp", "--ramp-seed-seconds", "8", "--ramp-seconds",
              "12"), 420),
    "mesh": (("--mesh", "4x2", "--seconds", "3", "--sat-trials", "1",
              "--latency-seconds", "3"), 240),
}
BENCH_LANES = (("workers", "overload"), ("ramp", "mesh"),
               ("default", "window", "replay", "chaos"))
# the pair: one saturation trial a leg
BENCH_AB = ("fastlane", "--seconds", "2", "--sat-trials", "1",
            "--latency-seconds", "2")
# the overload run's bar: each well-behaved tenant keeps this share of its
# baseline goodput beside the hog (`bench.py --overload`'s acceptance)
OVERLOAD_RETENTION = 0.9
# the mesh phases: the meshed pool's (tenants, devices a tenant, buckets),
# its mesh and fleet ticks; ring attention's batch, window, heads, width
# and sequence axis; the longwin rows; the data-parallel trainer's data
# axis, steps and batch
MESH_POOL = (8, FLEET // 8, (FLEET // 8,))
MESH_SPEC, MESH_TICKS = {"data": 2, "model": 2}, 4
RING_B, RING_W, RING_HEADS, RING_D, RING_AXIS = 1024, 512, 4, 32, 4
RING_ATOL = {"float32": 2e-5, "bfloat16": 2e-3}
LONGWIN_ROWS = 1024
# longwin sequence-parallel vs meshless: f32 outputs and loss; bf16 (a
# bf16 ulp of an output may land differently): share within LW_BF16_ATOL
LW_F32_ATOL, LW_F32_LOSS_RTOL = 1e-4, 1e-5
LW_BF16_ATOL, LW_BF16_SHARE, LW_BF16_LOSS_RTOL = 1e-2, 0.999, 1e-3
DP_DATA, DP_STEPS, DP_BATCH, DP_RTOL = 2, 5, 1024, 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def scratch_dir() -> str:
    """The checkout's gitignored `build/`: the durable and replay phases'
    data directories live (and are removed) under it."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(path, exist_ok=True)
    return path


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    log(card_line())
    # a float32 reference runs in full float32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.cuda.get_device_name(0)


def phase_build() -> None:
    from sitewhere_tpu_torch.ops.build import build_all

    t0 = time.perf_counter()
    reports = build_all()
    log(f"build: {len(reports)} source(s) (CUDA kernels and the store's "
        f"host library) in {time.perf_counter() - t0:.3f} s")
    for name, report in reports.items():
        # one line per compiled kernel: its template arguments (for
        # lstm_window: h, warps sharing a tile's units, tiles a CTA, rows
        # a tile), registers and spills, from nvcc's -Xptxas -v report
        entry, spill = "?", ""
        for line in report.splitlines():
            if "Compiling entry function" in line:
                args = re.findall(r"Li(\d+)E", line)
                entry = f"<{','.join(args)}>" if args else line.split("'")[1]
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                log(f"  {name}{entry}: {regs} registers, {spill}")


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
    from sitewhere_tpu_torch.utils.timing import cuda_median_ms

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
        return cuda_median_ms(lambda: lstm(seq), reps=10)


def phase_kernels(torch) -> list[dict]:
    from sitewhere_tpu_torch.models import build_model
    from sitewhere_tpu_torch.ops.lstm_kernel import (
        lstm_window_final,
        lstm_window_final_plain,
    )
    from sitewhere_tpu_torch.utils.timing import cuda_median_ms, graph_ms

    def layer_and_input(hidden, batch, gen):
        model = build_model("lstm", window=WINDOW, hidden=hidden)
        layer = model.init(torch.Generator().manual_seed(SEED))["lstm0"]
        # the main path hands the kernel xn[:, :-1] of a [B, W] window
        xw = torch.randn((batch, WINDOW), generator=gen).cuda()
        return layer, xw[:, :-1]

    def checked(layer, xn):
        got = lstm_window_final(layer, xn, torch.bfloat16)
        want = lstm_window_final_plain(layer["wx"], layer["wh"], layer["b"], xn)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not err < KERNEL_ATOL:
            raise AssertionError(
                f"kernel vs plain at B={xn.shape[0]}, h={layer['wh'].shape[0]}: "
                f"max |err| {err} >= {KERNEL_ATOL}")
        return err

    gen = torch.Generator().manual_seed(SEED + 1)
    rows, widths = [], []
    for batch in BUCKETS:
        layer, xn = layer_and_input(HIDDEN, batch, gen)
        err = checked(layer, xn)
        call = lambda: lstm_window_final(layer, xn, torch.bfloat16)  # noqa: E731
        ms = cuda_median_ms(call, reps=50)
        dev_ms = graph_ms(call)
        plain_ms = cuda_median_ms(
            lambda: lstm_window_final_plain(
                layer["wx"], layer["wh"], layer["b"], xn), reps=5, warmup=1)
        lib_ms = library_lstm_ms(torch, layer, xn.contiguous())
        bound_ms, bound_by = lstm_bound_ms(batch, WINDOW - 1, HIDDEN)
        row = {"batch": batch, "max_abs_err": err, "ms": ms,
               "graph_ms": dev_ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by}
        log(f"lstm_window_final B={batch}: {json.dumps(row)} "
            f"(CUDA-core design: ms {CUDA_CORE_MS[batch]})")
        rows.append(row)
    for hidden in WIDTHS:
        layer, xn = layer_and_input(hidden, WIDTH_BATCH, gen)
        row = {"hidden": hidden, "batch": WIDTH_BATCH,
               "max_abs_err": checked(layer, xn),
               "graph_ms": graph_ms(lambda: lstm_window_final(
                   layer, xn, torch.bfloat16))}
        log(f"lstm_window_final h={hidden}: {json.dumps(row)}")
        widths.append(row)
    return rows, widths


def stream_bound_ms(tenants: int, batch: int, hidden: int,
                    score_bytes: int) -> tuple[float, str]:
    """K2's least time on the card: a column reads its id and value and
    reads and writes h, c, pred, mean, var and count, and writes its
    score; a tenant's weights are read once."""
    cols = tenants * batch
    flops = cols * (8.0 * hidden * (1 + hidden) + 2.0 * hidden)
    weights = (4 * hidden + hidden * 4 * hidden + 4 * hidden + hidden + 1) * 4
    nbytes = (cols * (2 * (2 * hidden * 4 + 16) + 8 + score_bytes)
              + tenants * weights)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def stream_kernel_case(torch, model, tenants: int, batch: int,
                       score_dtype: str) -> dict:
    """K2 against the plain chain on copies of one stacked ring's state."""
    from sitewhere_tpu_torch.ops import lstm_stream_kernel as k2
    from sitewhere_tpu_torch.parallel import TenantStack
    from sitewhere_tpu_torch.scoring.stream import (
        StackedStreamingRing,
        streaming_step_plain,
    )
    from sitewhere_tpu_torch.utils.timing import cuda_median_ms, graph_ms

    rng = np.random.default_rng(SEED + 7 + batch + tenants)
    stack = TenantStack(model, seed=SEED)
    # stacked: one slot of the four left empty (all scratch padding)
    filled = tenants - 1 if tenants > 1 else 1
    for i in range(filled):
        stack.add_tenant(f"t{i}", model.init(
            torch.Generator().manual_seed(SEED + 11 * i)))
    ring = StackedStreamingRing(model, stack.capacity, device_cap=2 * batch,
                                score_dtype=score_dtype)
    cap = ring.device_cap  # ids in [0, cap); cap is the scratch row
    for tid, slot in stack.slots.items():
        x = rng.normal(20.0, 2.0, (cap, WINDOW)).astype(np.float32)
        count = rng.integers(0, WINDOW + 1, cap)  # some under the gate
        ring.load_tenant(slot, x, count, stack.get_params(tid))
    t = ring.t_cap
    dev = np.full((t, batch), cap, np.int32)
    for slot in stack.slots.values():
        # the last filled row of a stack only half full
        n = batch // 2 if tenants > 1 and slot == filled - 1 else batch
        dev[slot, :n] = rng.choice(cap, n, replace=False)
    real = torch.from_numpy(dev != cap).cuda()
    dev_t = torch.from_numpy(dev).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED + batch)
    values = 20.0 + 2.0 * torch.randn((STREAM_STEPS, t, batch),
                                      generator=gen, device="cuda")
    spikes = torch.rand(values.shape, generator=gen, device="cuda") < 0.01
    values = torch.where(spikes, values + 24.0, values)
    # the plain chain in the ring's score type (timed) and in float32 (the
    # yardstick of K2's scores)
    plain = streaming_step_plain(model, ring.score_dtype, stacked=True)
    plain32 = streaming_step_plain(model, None, stacked=True)
    state_k = ring.state
    state_p = {k: leaf.clone() for k, leaf in state_k.items()}
    params = stack.stacked
    cfg = model.cfg

    def kernel(v):
        return k2.lstm_stream_step(
            params, state_k, dev_t, v, window=cfg.window,
            min_count=model.min_history, score_clip=cfg.score_clip,
            out_dtype=ring.score_dtype)

    launches0 = k2.launches
    errs = []
    for step in range(STREAM_STEPS):
        got = kernel(values[step]).float()
        want = plain32(params, state_p, dev_t, values[step])
        rel = (got - want).abs() / want.abs().clamp(min=1.0)
        errs.append(torch.where(real, rel, torch.zeros_like(rel)).max())
    torch.cuda.synchronize()
    if k2.launches - launches0 != STREAM_STEPS:
        raise AssertionError(f"stream kernel: {k2.launches - launches0} "
                             f"launches for {STREAM_STEPS} steps")
    err = float(torch.stack(errs).max())
    tol = STREAM_KERNEL_TOL + SCORE_ROUNDING[score_dtype]
    gaps = {k: float((state_k[k][:, :cap].float()
                      - state_p[k][:, :cap].float()).abs().max())
            for k in (*STREAM_STATE_TOL, *STREAM_EXACT)}
    off = {k: g for k, g in gaps.items()
           if not g <= STREAM_STATE_TOL.get(k, 0.0)}
    if not err <= tol or off:
        raise AssertionError(
            f"stream kernel vs plain at T={t}, B={batch}, {score_dtype} "
            f"scores: max |Δscore| / max(1, |plain|) {err} (tolerance "
            f"{tol}), state gaps past {STREAM_STATE_TOL} (mean, var and "
            f"count: 0) {off}")
    v0 = values[0]
    # the wrapper's checks of one call's inputs, alone (inside `ms`)
    n_checks = 1000
    t0 = time.perf_counter()
    for _ in range(n_checks):
        k2.check(params, state_k, dev_t, v0, ring.score_dtype)
    check_ms = 1e3 * (time.perf_counter() - t0) / n_checks
    ms = cuda_median_ms(lambda: kernel(v0), reps=50)
    dev_ms = graph_ms(lambda: kernel(v0))
    plain_ms = cuda_median_ms(lambda: plain(params, state_p, dev_t, v0),
                              reps=10)
    # the host side of one ring dispatch (pad check, uploads, the step),
    # with K2 and with the plain chain in its place
    vals = rng.normal(20.0, 2.0, dev.shape).astype(np.float32)

    def host_ms(ring) -> float:
        times = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ring.update_and_score(model, params, dev, vals)
            times.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        return float(np.median(times))

    k_host = host_ms(ring)
    ring._step = plain
    p_host = host_ms(ring)
    score_bytes = 2 if ring.score_dtype in (torch.float16,
                                            torch.bfloat16) else 4
    bound_ms, bound_by = stream_bound_ms(t, batch, HIDDEN, score_bytes)
    ring.close()
    return {"tenants": t, "batch": batch, "scores": score_dtype,
            "max_score_err": err, "max_h_err": gaps["h0"],
            "max_c_err": gaps["c0"], "max_pred_err": gaps["pred"],
            "max_mean_err": gaps["mean"], "max_var_err": gaps["var"],
            "ms": ms, "graph_ms": dev_ms, "plain_ms": plain_ms,
            "check_ms": check_ms, "host_ms": k_host, "plain_host_ms": p_host,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_stream_kernel(torch) -> list[dict]:
    """K2 against its plain chain at every bucket, one tenant and four."""
    from sitewhere_tpu_torch.models import build_model

    model = build_model("lstm-stream", window=WINDOW, hidden=HIDDEN)
    if not model.fused:
        raise AssertionError("the main path's lstm-stream does not take K2")
    cases = [(tenants, batch, "float16" if tenants == 1 else "float32")
             for tenants in STREAM_TENANTS for batch in BUCKETS]
    cases.append((*STREAM_BF16, "bfloat16"))
    rows = []
    for tenants, batch, scores in cases:
        row = stream_kernel_case(torch, model, tenants, batch, scores)
        log(f"lstm_stream_step T={row['tenants']} B={batch} {scores}: "
            f"{json.dumps(row)}")
        rows.append(row)
    return rows


def tft_inputs(torch, gen, shape, shift=0, scale=3.0):
    """float32 values of `shape` on the card with the cases the roundings
    and the transcendentals turn on: a sixteenth each of zeros, negative
    zeros, large magnitudes (±1e4) and exact ties between two bf16
    values; `shift` elements into their buffer (1: not 16-byte aligned,
    so the kernels take a column at a time)."""
    n = int(np.prod(shape))
    x = torch.randn(n + shift, generator=gen, device="cuda")[shift:].view(
        shape) * scale
    pick = torch.randint(0, 16, shape, generator=gen, device="cuda",
                         dtype=torch.uint8)
    ties = (x.to(torch.bfloat16).float().view(torch.int32) + 0x8000).view(
        torch.float32)
    x = torch.where(pick == 0, torch.zeros_like(x), x)
    x = torch.where(pick == 1, torch.full_like(x, -0.0), x)
    x = torch.where(pick == 2, x * 1e4 / scale, x)
    x = torch.where(pick == 3, ties, x)
    if not shift:
        return x
    out = torch.empty(n + shift, device="cuda")[shift:].view(shape)
    return out.copy_(x)


def tft_kernel_cases(torch, k3, gen, rows: int, kind: int,
                     shift: int = 0) -> dict:
    """name → a function making (the op table's entry, its args, bytes it
    must move, FLOP it must compute) at the electricity widths, `rows`
    windows: the shapes the served forward hands each kernel (the
    selection's past context, a recurrence step, the attention's logits);
    the embeddings at half the rows (their outputs are four inputs wide);
    the inputs `shift` elements off alignment. A dense layer takes its
    rounded operand and weight: the past selection's first layer (K = 640,
    its context term and ELU) and a GRN's second (K = 160) through the
    fused kernel, and the attention's shared value (N = 40) through cuBLAS
    and the epilogue's kernel."""
    wc, d = TFT_WIDTHS["window"] - TFT_WIDTHS["horizon"], TFT_WIDTHS["hidden"]
    hz, w, nh = TFT_WIDTHS["horizon"], TFT_WIDTHS["window"], TFT_WIDTHS["heads"]
    t = lambda *shape: tft_inputs(torch, gen, shape, shift)  # noqa: E731
    r = lambda *shape: k3.round_plain(t(*shape), kind)[0]  # noqa: E731
    act = (rows, wc, d)
    e4 = rows * wc * d * 4                      # one float32 activation

    def vsn():
        lns = [(t(*act), t(rows, wc, 1), t(rows, wc, 1).abs(), t(d), t(d))
               for _ in range(4)]
        weights = torch.softmax(t(rows, wc, 4), dim=-1)
        return ("vsn", (*(list(z) for z in zip(*lns)), weights, kind),
                6 * e4 + rows * wc * 4 * 4, 0)

    def embed():
        half = rows // 2
        feats = t(half, w, 4)[:, :wc]           # the model's strided slice
        ws = [k3.round_plain(t(1, d), kind)[0] for _ in range(4)]
        return ("embed", (feats, ws, [t(d) for _ in range(4)], kind),
                half * wc * 4 * (4 + 12 * d), 0)

    def product(lead, k, n, moved):
        """bytes and FLOP of a product over `lead` rows: x read, and `moved`
        floats a row read or written by its epilogue"""
        m = int(np.prod(lead))
        return m * (k + moved) * 4, 2.0 * m * k * n

    return {
        "round": lambda: ("round", (t(*act), kind), 2 * e4, 0),
        "dense": lambda: ("dense", (r(rows, wc, 4 * d), r(4 * d, d), t(d),
                                    t(rows, 1, d), t(d), True, k3.BOTH, kind),
                          *product((rows, wc), 4 * d, d, 2 * d)),
        "dense_k160": lambda: ("dense", (r(*act), r(d, d), t(d), None, None,
                                         False, k3.ROUNDED, kind),
                               *product((rows, wc), d, d, d)),
        "gate": lambda: ("gate", (t(rows, wc, 2 * d), t(2 * d), t(*act),
                                  None, kind), 4 * e4, 0),
        "dense_n40": lambda: ("dense", (r(rows, w, d), r(d, d // nh),
                                        t(d // nh), None, None, False,
                                        k3.ROUNDED, kind),
                              *product((rows, w), d, d // nh, d // nh)),
        "sqdev": lambda: ("sqdev", (t(*act), t(rows, wc, 1), kind), 2 * e4,
                          0),
        "ln": lambda: ("ln", (t(*act), t(rows, wc, 1), t(rows, wc, 1).abs(),
                              t(d), t(d), k3.BOTH, kind), 3 * e4, 0),
        "vsn": vsn,
        # eight steps of the recurrence; its product's FLOP at the float32
        # SIMT peak and its bytes (the product reads h and writes h·wh; the
        # cell reads the step's input product, h·wh and c and writes c, h
        # and h's slot of the output)
        "lstm": lambda: ("lstm", (t(rows, 8, 4 * d),
                                  k3.round_plain(t(d, 4 * d), kind)[0]
                                  / d ** 0.5,
                                  t(4 * d), k3.round_plain(t(rows, d),
                                                           kind)[0],
                                  t(rows, d), kind),
                         8 * rows * d * 4 * 17.0,
                         8 * 2.0 * rows * d * 4 * d),
        "embed": embed,
        "logits": lambda: ("logits", (t(rows, nh, hz, w),
                                      torch.rand((rows, 1, 1, w),
                                                 generator=gen,
                                                 device="cuda") > 0.05,
                                      wc, float(np.sqrt(d // nh)), kind),
                           rows * nh * hz * w * 8 + rows * w, 0),
    }


def same_tensors(label: str, got, want) -> None:
    """Every output of a kernel equal to its plain version's, bit for bit
    (NaN where NaN)."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} outputs, plain "
                             f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape:
            raise AssertionError(f"{label} output {i}: shape {list(g.shape)}"
                                 f", plain {list(w.shape)}")
        bad = ~((g == w) | (g.isnan() & w.isnan()))
        n = int(bad.sum())
        if n:
            raise AssertionError(
                f"{label} output {i}: {n} of {g.numel()} values differ from "
                f"the plain chain's, e.g. {g[bad][:4].tolist()} against "
                f"{w[bad][:4].tolist()}")


def tft_fused_kernels(torch) -> list[dict]:
    """Each K3 kernel against its plain version on the card, bit for bit,
    and timed at the electricity widths' 16,384-row shapes (bf16), then
    checked again in float16 and off alignment. A fused product's
    `library_ms` is torch.matmul and K3's epilogue kernel at its shape."""
    from sitewhere_tpu_torch.ops import tft_fused as k3
    from sitewhere_tpu_torch.utils.timing import cuda_median_ms, graph_ms

    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    rows = []
    for name, case in tft_kernel_cases(torch, k3, gen, TFT_ROWS, 0).items():
        entry, args, nbytes, flop = case()
        op, plain = getattr(k3.OPS, entry), getattr(k3.PLAIN, entry)
        launches0, products0 = k3.launches, k3.product_launches
        got = op(*args)
        torch.cuda.synchronize()
        # one launch a call, the recurrence one a step
        expect = args[0].shape[-2] if name == "lstm" else 1
        fused = entry == "dense" and k3.fits(args[0], args[1])
        if (k3.launches - launches0 != expect
                or k3.product_launches - products0 != int(fused)):
            raise AssertionError(f"tft-fused {name}: {k3.launches - launches0}"
                                 f" launches for one call, not {expect}, "
                                 f"{k3.product_launches - products0} fused "
                                 f"products, not {int(fused)}")
        want = plain(*args)
        same_tensors(f"tft-fused {name}", got, want)
        del got, want
        ms = cuda_median_ms(lambda: op(*args), reps=10)
        dev_ms = graph_ms(lambda: op(*args), launches=2, reps=5)
        plain_ms = cuda_median_ms(lambda: plain(*args), reps=5)
        bound_ms = 1e3 * max(nbytes / PEAK_BYTES_S, flop / PEAK_F32_FLOPS)
        row = {"kernel": name, "rows": TFT_ROWS, "ms": ms, "graph_ms": dev_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": ("operations" if flop / PEAK_F32_FLOPS
                            > nbytes / PEAK_BYTES_S else "bytes"),
               "bound_share": bound_ms / dev_ms, "fused": fused}
        if fused:
            x, wt, rest = args[0], args[1], args[2:]
            row["library_ms"] = cuda_median_ms(
                lambda: k3._dense_epilogue(x @ wt, *rest), reps=10)
            row["cublas_ms"] = cuda_median_ms(lambda: x @ wt, reps=10)
            row["tflops"] = flop / dev_ms / 1e9
        log(f"tft-fused {name}: {json.dumps(row)}")
        rows.append(row)
        del args
        torch.cuda.empty_cache()
    # float16 rounding, and every kernel again a column at a time (inputs
    # off 16-byte alignment: the products then go to cuBLAS and the
    # epilogue's kernels) in both types
    for kind, shift in ((1, 0), (0, 1), (1, 1)):
        for name, case in tft_kernel_cases(torch, k3, gen, TFT_F16_ROWS,
                                           kind, shift).items():
            entry, args, _, _ = case()
            same_tensors(f"tft-fused {name} kind {kind} shift {shift}",
                         getattr(k3.OPS, entry)(*args),
                         getattr(k3.PLAIN, entry)(*args))
    log(f"tft-fused: all {len(k3.KERNELS)} kernels equal to their plain "
        f"versions in bfloat16 ({TFT_ROWS} rows) and float16 "
        f"({TFT_F16_ROWS} rows), four columns a thread and one")
    return rows


def probe_operands(torch, gen, shape, kind: int):
    """float32 values of the rounding type, of random sign and mantissa,
    exponents spread over ±TFT_PROBE_SPAN[kind], a 64th of them zeros."""
    span = TFT_PROBE_SPAN[kind]
    m = 1.0 + torch.rand(shape, generator=gen, device="cuda")
    e = torch.randint(-span, span + 1, shape, generator=gen,
                      device="cuda").float()
    sign = torch.where(torch.rand(shape, generator=gen, device="cuda") < 0.5,
                       -1.0, 1.0)
    x = torch.where(torch.rand(shape, generator=gen, device="cuda") < 1 / 64,
                    0.0, sign * m * torch.exp2(e))
    return x.to(torch.bfloat16 if kind == 0 else torch.float16).float()


def tft_order_probe(torch) -> dict:
    """cuBLAS's float32 product (torch.matmul, and under `vmap` as the pool
    runs it) against `k3.probe`, the k-ascending sum, at every product
    shape of the forward (`TFT_PRODUCTS`) and bucket: where the fused
    kernel takes the shape (`k3.fits`), every value equal; elsewhere the
    count that differs is logged. Returns (config, rows a window, K, N)
    → the buckets and modes where cuBLAS summed in another order."""
    from sitewhere_tpu_torch.ops import tft_fused as k3

    assert not torch.backends.cuda.matmul.allow_tf32
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    other, cases = {}, 0
    for config, products in TFT_PRODUCTS.items():
        for kind in (0, 1):
            for steps, shapes in products.items():
                for k, n in shapes:
                    for bucket in TFT_PROBE_BUCKETS[config]:
                        lead = (bucket, steps) if steps > 1 else (bucket,)
                        modes = [("one", 1), ("vmap", 1)]
                        if bucket == 1024:
                            modes.append(("vmap", 4))
                        for mode, tenants in modes:
                            if mode == "one":
                                x = probe_operands(torch, gen, (*lead, k),
                                                   kind)
                                w = probe_operands(torch, gen, (k, n), kind)
                                want = x @ w
                            else:
                                x = probe_operands(torch, gen,
                                                   (tenants, *lead, k), kind)
                                w = probe_operands(torch, gen,
                                                   (tenants, k, n), kind)
                                want = torch.func.vmap(torch.matmul)(x, w)
                            differ = int((k3.probe(x, w) != want).sum())
                            cases += 1
                            if differ:
                                key = f"{config} {steps}x{k}x{n}"
                                other.setdefault(key, []).append(
                                    f"{bucket} {mode}{tenants} kind {kind}: "
                                    f"{differ} of {want.numel()}")
                                if k3.fits(x, w):
                                    raise AssertionError(
                                        f"order probe: cuBLAS sums "
                                        f"{key} at bucket {bucket} ({mode}, "
                                        f"{tenants} tenants, kind {kind}) "
                                        f"in another order ({differ} of "
                                        f"{want.numel()} values), and the "
                                        f"fused kernel takes it")
                            del x, w, want
                torch.cuda.empty_cache()
    log(f"tft-fused order probe: {cases} products, every one the fused "
        f"kernel takes summed by cuBLAS in ascending k; in another order: "
        f"{json.dumps(other)}")
    return other


def tft_product_checks(torch) -> list[dict]:
    """Each fused product through `OPS` against `PLAIN` (cuBLAS and the
    plain epilogue), bit for bit: the electricity widths' past selection
    (K = 640, context, ELU) and a GRN's K = 160 layer, at buckets 256
    and 16,384, vmapped over one tenant and not (and three tenants of
    their own weights at 256), in bfloat16 and float16, and off alignment
    (cuBLAS and the epilogue's kernel); at `TftConfig`'s defaults the same
    layers at 4,096 windows."""
    from sitewhere_tpu_torch.ops import tft_fused as k3

    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    out = []
    widths = {"electricity": (TFT_WIDTHS["hidden"], 168, (256, 16384)),
              "defaults": (32, 56, (4096,))}
    for config, (d, steps, buckets) in widths.items():
        for kind in (0, 1):
            for bucket in buckets:
                modes = [("one", 1, 0), ("vmap", 1, 0)]
                if bucket == buckets[0]:
                    modes += [("vmap", 3, 0), ("one", 1, 1)]
                for mode, tenants, shift in modes:
                    lead = ((bucket, steps) if mode == "one"
                            else (tenants, bucket, steps))
                    wl = () if mode == "one" else (tenants,)
                    t = lambda *shape: tft_inputs(  # noqa: E731
                        torch, gen, shape, shift)
                    r = lambda *shape: probe_operands(  # noqa: E731
                        torch, gen, shape, kind)
                    cases = {
                        "past selection": ("dense", (
                            r(*lead, 4 * d), r(*wl, 4 * d, d), t(*wl, d),
                            t(*lead[:-1], 1, d), t(*wl, d), True, k3.BOTH,
                            kind)),
                        "grn layer": ("dense", (
                            r(*lead, d), r(*wl, d, d), t(*wl, d), None, None,
                            False, k3.ROUNDED, kind)),
                    }
                    for name, (entry, args) in cases.items():
                        if shift:    # the operand off 16-byte alignment
                            x = args[0]
                            moved = torch.empty(x.numel() + 1,
                                                device="cuda")[1:].view(
                                x.shape).copy_(x)
                            args = (moved, *args[1:])
                        op, plain = getattr(k3.OPS, entry), getattr(
                            k3.PLAIN, entry)
                        if mode == "vmap":
                            dims = tuple(0 if isinstance(a, torch.Tensor)
                                         else None for a in args)
                            op, plain = (torch.func.vmap(op, in_dims=dims),
                                         torch.func.vmap(plain,
                                                         in_dims=dims))
                        p0 = k3.product_launches
                        got = op(*args)
                        fused = k3.product_launches - p0
                        if fused != int(not shift):
                            raise AssertionError(
                                f"tft-fused product {config} {name}: "
                                f"{fused} fused launches, shift {shift}")
                        label = (f"tft-fused product {config} {name} bucket "
                                 f"{bucket} {mode}{tenants} kind {kind} "
                                 f"shift {shift}")
                        same_tensors(label, got, plain(*args))
                        out.append({"config": config, "product": name,
                                    "bucket": bucket, "mode": mode,
                                    "tenants": tenants, "kind": kind,
                                    "shift": shift, "fused": fused})
                        del got, args
                    del cases
                    torch.cuda.empty_cache()
    log(f"tft-fused: {len(out)} products through OPS equal to PLAIN's "
        f"(cuBLAS and the plain epilogue)")
    return out


def tft_device_ops(torch, fn) -> int:
    """Device operations (kernels, copies, fills) one call of `fn` puts on
    the card, from the profiler's records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and not e.is_user_annotation())


# the stages' outputs (`tft_stages`), by the range each is computed in
TFT_STAGES = {"tft.select": slice(0, 3), "tft.seq2seq": slice(3, 4),
              "tft.attend": slice(4, 6)}


def tft_stages(torch, k3, model, ops, params, xn, valid,
               vmapped: bool) -> list:
    """The TFT's stages through the op table `ops` on normalized windows
    `xn`: [static context, selected past, selected future, sequence,
    quantiles, attention], vmapped over one stacked tenant (as the pool
    scores) or not."""
    from torch.utils._pytree import tree_map

    kind = k3.ROUNDINGS[model.cfg.compute_dtype]

    def stages(p, x, v):
        r = k3.rounded_weights(ops, p, kind)
        static, past, fut = model._select(ops, r, x, v, kind)
        seq = model._seq2seq(ops, r, past, fut, kind)
        quant, attn = model._attend(ops, r, seq, static[1], v, kind)
        return static[0], past[0], fut[0], seq[0], quant, attn

    if not vmapped:
        return list(stages(params, xn, valid))
    stacked = tree_map(lambda a: a[None].contiguous(), params)
    return [o[0] for o in torch.func.vmap(stages)(stacked, xn[None],
                                                  valid[None])]


def tft_stage_check(torch, k3, ref, model, params, x, label: str,
                    with_reference: bool) -> None:
    """The stages through `OPS` against the same code through `PLAIN` (and
    the reference's) on windows `x`, all valid, vmapped and not."""
    cfg = model.cfg
    widths = {"window": cfg.window, "horizon": cfg.horizon,
              "hidden": cfg.hidden, "heads": cfg.heads,
              "quantiles": list(cfg.quantiles)}
    valid = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    xn, _, _ = model._normalize(x, valid)
    want = None
    if with_reference:
        m = ref._Weights(params, cfg.compute_dtype)
        c_s, past, known = ref.selection(m, widths, ref.normalise(widths, x))
        seq = ref.sequence(m, past, known)
        want = [c_s, past, known, seq, ref.attention(m, widths, seq, c_s)]
        del m, c_s, past, known, seq
    for vmapped in (False, True):
        how = f"{label} {'vmapped' if vmapped else 'one'}"
        fused = tft_stages(torch, k3, model, k3.OPS, params, xn, valid,
                           vmapped)
        plain = tft_stages(torch, k3, model, k3.PLAIN, params, xn, valid,
                           vmapped)
        for stage, outs in TFT_STAGES.items():
            same_tensors(f"{how} {stage}, OPS against PLAIN", fused[outs],
                         plain[outs])
        del plain
        if want is not None:      # the reference's attention gives no weights
            for stage, outs in TFT_STAGES.items():
                same_tensors(f"{how} {stage} against the reference",
                             fused[:5][outs], want[outs])
        del fused
        torch.cuda.empty_cache()


def tft_forward_check(torch, model, params, x, vmapped: bool,
                      plain_score) -> tuple:
    """The scores of windows `x` through `OPS` against those through
    `PLAIN`, vmapped over one stacked tenant (as the pool scores) or not;
    returns (scores, K3 launches of the forward, the forward)."""
    from torch.utils._pytree import tree_map

    from sitewhere_tpu_torch.ops import tft_fused as k3

    valid = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    if vmapped:
        stacked = tree_map(lambda a: a[None].contiguous(), params)
        score = lambda: torch.func.vmap(model.score)(  # noqa: E731
            stacked, x[None], valid[None])[0]
    else:
        score = lambda: model.score(params, x, valid)  # noqa: E731
    launches0 = k3.launches
    got = score()
    launches = k3.launches - launches0
    if not launches:
        raise AssertionError("the TFT forward on the card did not run OPS")
    launches0 = k3.launches
    want = plain_score(score)
    if k3.launches != launches0:
        raise AssertionError("the TFT forward through PLAIN launched K3")
    same_tensors("tft scores, OPS against PLAIN", [got], [want])
    return got, launches, score


def tft_forward_ms(torch, fn, reps: int = 5) -> dict:
    """The host's enqueue of `fn` from an idle card (host clock, ms) and
    its device time (CUDA events, ms), `reps` times each."""
    host, device = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        host.append(1e3 * (time.perf_counter() - t0))
        end.record()
        torch.cuda.synchronize()
        device.append(start.elapsed_time(end))
    return {"host_ms": host, "device_ms": device}


def phase_tft_fused(torch) -> dict:
    """K3's kernels, then the TFT's stages and scores through `OPS` against
    `PLAIN` and the benchmark's reference at every bucket."""
    from sitewhere_tpu_torch.models import build_model
    from sitewhere_tpu_torch.ops import tft_fused as k3
    from swxbench.reference import tft as ref

    probe = tft_order_probe(torch)
    products = tft_product_checks(torch)
    rows = tft_fused_kernels(torch)

    def plain_score(fn):
        """`fn` with the forward's op table forced to `PLAIN`."""
        table = k3.table
        k3.table = lambda params, x, cdt: k3.PLAIN
        try:
            return fn()
        finally:
            k3.table = table

    model = build_model("tft", **TFT_WIDTHS)
    widths = {**TFT_WIDTHS, "quantiles": [0.1, 0.5, 0.9]}
    params = ref.make_params(widths, SEED, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    out = {"kernels": rows, "buckets": [], "order_probe_other": probe,
           "products_checked": len(products)}
    for bucket in TFT_BUCKETS:
        x = 20.0 + 3.0 * torch.randn((bucket, TFT_WIDTHS["window"]),
                                     generator=gen, device="cuda")
        spikes = torch.rand(x.shape, generator=gen, device="cuda") < 0.001
        x = torch.where(spikes, x + 12.0, x)
        tft_stage_check(torch, k3, ref, model, params, x, f"tft {bucket}",
                        with_reference=True)
        want = ref.window_scores(params, widths, x, torch.bfloat16)
        row = {"bucket": bucket}
        for vmapped in (False, True):
            products0 = k3.product_launches
            got, launches, score = tft_forward_check(
                torch, model, params, x, vmapped, plain_score)
            same_tensors(f"tft {bucket} scores vs reference", [got], [want])
            row["k3_launches" + ("_vmap" if vmapped else "")] = launches
            row["fused_products" + ("_vmap" if vmapped else "")] = (
                k3.product_launches - products0)
        if bucket == 1024:
            row["device_ops_plain"] = tft_device_ops(
                torch, lambda: plain_score(score))
            row["device_ops_k3"] = tft_device_ops(torch, score)
        if bucket == TFT_ROWS:    # vmapped, as the pool runs it
            row["forward"] = tft_forward_ms(torch, score)
        log(f"tft-fused bucket {bucket}: stages and scores through OPS equal "
            f"to PLAIN's and the reference's, {json.dumps(row)}")
        out["buckets"].append(row)
        torch.cuda.empty_cache()
    # the pool's `tft` at `TftConfig`'s defaults (W=64, d=32): bit-equal too
    small = build_model("tft")
    small_params = small.init(torch.Generator().manual_seed(SEED))
    x = 20.0 + 3.0 * torch.randn((4096, small.cfg.window), generator=gen,
                                 device="cuda")
    tft_stage_check(torch, k3, ref, small, small_params, x, "tft defaults",
                    with_reference=False)
    for vmapped in (False, True):
        tft_forward_check(torch, small, small_params, x, vmapped, plain_score)
    log("tft-fused: TftConfig's defaults through OPS equal to PLAIN, "
        "vmapped and not")
    return out


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


def anomaly_tick(sim, sim_cfg, t: float):
    """A fleet tick with 5% of devices spiking by 12 sigma."""
    sim.cfg = SimConfig(num_devices=sim_cfg.num_devices, seed=sim_cfg.seed,
                        anomaly_rate=0.05, anomaly_magnitude=12.0)
    tick = sim.tick(t=t)
    sim.cfg = sim_cfg
    return tick


def session_plan(path) -> list:
    """The dedicated sessions' flushes: (label, [(batch, truth)], anomaly
    tick?) for six fleet ticks, an anomaly tick, a flush holding
    duplicate devices and two small flushes."""
    sim, t = path.sim, path.t
    plan = [("fleet", [sim.tick(t=t + TICK_S * k)], False) for k in range(6)]
    t += TICK_S * 6
    plan.append(("anomalies", [anomaly_tick(sim, path.sim_cfg, t)], True))
    dup = np.arange(3000, dtype=np.uint32)
    plan.append(("duplicates", [sim.tick(t=t + 30.0, devices=dup),
                                sim.tick(t=t + 45.0, devices=dup)], False))
    plan.append(("small-256", [sim.tick(t=t + 60.0, devices=np.arange(
        200, dtype=np.uint32))], False))
    plan.append(("small-1024", [sim.tick(t=t + 60.0, devices=np.arange(
        5000, 5900, dtype=np.uint32))], False))
    return plan


def check_anomalies(label: str, scores: np.ndarray, truth: np.ndarray) -> None:
    a_med = float(np.median(scores[truth]))
    n_p99 = float(np.quantile(scores[~truth], 0.99))
    log(f"{label}: anomalies {int(truth.sum())}: median score {a_med}, "
        f"normal p99 {n_p99}")
    if not a_med > n_p99:
        raise AssertionError(f"{label}: injected anomalies do not stand out")


def check_scored(label: str, scored, dev: np.ndarray) -> None:
    """Every event scored (in arrival order), every score finite."""
    if (len(scored) != dev.shape[0]
            or not np.array_equal(scored.device_index, dev)
            or not np.isfinite(scored.score).all()):
        raise AssertionError(f"{label}: {len(scored)} scores for "
                             f"{dev.shape[0]} events, finite="
                             f"{np.isfinite(scored.score).all()}")


def check_close(label: str, got: np.ndarray, ref: np.ndarray) -> float:
    """`got` (float16 readback) against a float32 reference narrowed the
    same way: atol SCORE_ATOL plus SCORE_RTOL relative."""
    ref = ref.astype(np.float16).astype(np.float32)
    err = np.abs(got - ref)
    if not (err <= SCORE_ATOL + SCORE_RTOL * np.abs(ref)).all():
        raise AssertionError(f"{label}: scores vs the reference, max |err| "
                             f"{err.max()}")
    return float(err.max()) if err.size else 0.0


def check_share(label: str, got: np.ndarray, ref: np.ndarray,
                floor: tuple[float, float]) -> dict:
    """`check_close`'s comparison held in aggregate (BF16_SHARE_FLOOR):
    at least `floor[0]` of the rows within the tolerance and the p99
    |err| at most `floor[1]`; returns max and p99 |err| and the share."""
    ref = ref.astype(np.float16).astype(np.float32)
    err = np.abs(got - ref)
    out = {"max_abs_err": float(err.max()),
           "p99_abs_err": float(np.quantile(err, 0.99)),
           "share_within": float((err <= SCORE_ATOL
                                  + SCORE_RTOL * np.abs(ref)).mean())}
    if out["share_within"] < floor[0] or out["p99_abs_err"] > floor[1]:
        raise AssertionError(f"{label}: bf16 sample vs the reference {out} "
                             f"below the floor {floor}")
    return out


def occurrence_rounds(dev: np.ndarray) -> int:
    """Dispatches a duplicate-free split of `dev` needs: its largest
    per-device event count."""
    return int(np.unique(dev, return_counts=True)[1].max())


def time_calls(obj, name: str) -> list:
    """Wrap `obj.name` to log each call's host milliseconds into the list
    returned: the host side of a pool's or a session's dispatch (its
    `scoring.dispatch` step), read without a profiler."""
    inner, out = getattr(obj, name), []

    def timed(*args):
        t0 = time.perf_counter()
        try:
            return inner(*args)
        finally:
            out.append(1e3 * (time.perf_counter() - t0))

    setattr(obj, name, timed)
    return out


def path_stats(flush_ms, host_ms, n_events, busy_s, n_dispatch,
               launches) -> dict:
    return {"events": n_events, "flushes": len(flush_ms),
            "dispatches": n_dispatch, "events_per_s": n_events / busy_s,
            "flush_p50_ms": float(np.quantile(flush_ms, 0.5)),
            "flush_p99_ms": float(np.quantile(flush_ms, 0.99)),
            "host_ms_per_flush_p50": float(np.quantile(host_ms, 0.5)),
            "kernel_launches": launches}


class StreamReference:
    """The streaming model on the CPU for a sample of one tenant's
    devices: state from `warm_state` on their host windows (the store as
    the path seeded its ring from it), then `step_score` over the same
    events in arrival order. Independent of the path under test: no
    ring, no stack, no card."""

    def __init__(self, torch, params: dict, store, devices: np.ndarray):
        from sitewhere_tpu_torch.convert import params_from_numpy, params_to_numpy
        from sitewhere_tpu_torch.models import build_model

        self.torch = torch
        self.model = build_model("lstm-stream", device="cpu", window=WINDOW,
                                 hidden=HIDDEN)
        self.params = params_from_numpy(params_to_numpy(params), "cpu")
        self.row = np.full(int(devices.max()) + 1, -1, np.int64)
        self.row[devices] = np.arange(devices.shape[0])
        if store is None:
            # a cold slot (a replay's): the ring's zero state
            self.state = self.model.init_state(devices.shape[0])
            return
        x, valid = store.window(devices, WINDOW)
        self.state = self.model.warm_state(self.params, torch.from_numpy(x),
                                           torch.from_numpy(valid))

    def step(self, dev: np.ndarray, val: np.ndarray):
        """Advance over one flush's events; returns (positions of the
        sampled devices' events, their reference scores)."""
        torch = self.torch
        known = dev < self.row.shape[0]
        pos = np.nonzero(known)[0]
        pos = pos[self.row[dev[pos]] >= 0]
        rows = self.row[dev[pos]]
        # occurrence rank of each event among its device's events
        order = np.argsort(rows, kind="stable")
        _, start, cnt = np.unique(rows[order], return_index=True,
                                  return_counts=True)
        rank = np.empty_like(rows)
        rank[order] = np.arange(rows.shape[0]) - np.repeat(start, cnt)
        ref = np.empty(rows.shape[0], np.float32)
        for r in range(int(rank.max()) + 1 if rank.size else 0):
            sel = rank == r
            idx = torch.from_numpy(rows[sel])
            sub = {k: v[idx] for k, v in self.state.items()}
            score, new = self.model.step_score(
                self.params, sub, torch.from_numpy(val[pos[sel]]))
            for k, v in self.state.items():
                v[idx] = new[k]
            ref[sel] = score.numpy()
        return pos, ref


async def phase_main(torch) -> dict:
    from sitewhere_tpu_torch.ops import lstm_kernel
    from sitewhere_tpu_torch.tools import main_path

    t_setup = time.perf_counter()
    path = main_path.build("smoke")
    model, session, metrics = path.model, path.session, path.metrics
    torch.cuda.synchronize()
    log(f"main: set-up (store fill + warmup) "
        f"{time.perf_counter() - t_setup:.3f} s")

    plan = session_plan(path)
    dispatches = metrics.counter("scoring.dispatches")
    d0 = dispatches.value
    lstm_kernel.launches = 0
    rng = np.random.default_rng(SEED)
    flush_ms, host_ms, n_events, busy_s = [], [], 0, 0.0
    for label, ticks, anomalous in plan:
        t0 = time.perf_counter()
        for batch, _ in ticks:
            path.ingest(batch)
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
            check_anomalies("main", scored.score, ticks[0][1])
    launches = lstm_kernel.launches
    n_dispatch = int(dispatches.value - d0)
    if launches == 0 or launches != n_dispatch:
        raise AssertionError(f"kernel launches {launches} != dispatches "
                             f"{n_dispatch}")
    await session.drain()
    stats = path_stats(flush_ms, host_ms, n_events, busy_s, n_dispatch,
                       launches)
    log(f"main: {json.dumps(stats)}")
    return stats


async def phase_stream(torch) -> dict:
    """The dedicated session on the streaming model, then its sparse
    readback twin on the same anomaly tick."""
    from sitewhere_tpu_torch.ops import lstm_kernel
    from sitewhere_tpu_torch.ops import lstm_stream_kernel as k2
    from sitewhere_tpu_torch.tools import main_path

    t_setup = time.perf_counter()
    path = main_path.build("stream", "lstm-stream")
    # k=1024 slots a 16384-event dispatch hold the anomaly tick's ≈820 a
    # dispatch, so the sets compare whole (overflow would be counted)
    sparse = main_path.build("stream", "lstm-stream", readback="anomalies",
                             sparse_k=1024)
    rng = np.random.default_rng(SEED + 2)
    sample = np.sort(rng.choice(FLEET, SAMPLE, replace=False))
    ref = StreamReference(torch, path.session.params, path.store, sample)
    torch.cuda.synchronize()
    log(f"stream: set-up (store fills, warmups, CPU reference seed) "
        f"{time.perf_counter() - t_setup:.3f} s")
    plan = session_plan(path)
    dispatches = path.metrics.counter("scoring.dispatches")
    took = path.metrics.counter("scoring.stream_kernel_dispatches")
    # the sparse twin's dispatches launch K2 too
    sparse_dispatches = sparse.metrics.counter("scoring.dispatches")
    sparse_took = sparse.metrics.counter("scoring.stream_kernel_dispatches")
    d0, k0, expect = dispatches.value, took.value, 0
    sd0, sk0 = sparse_dispatches.value, sparse_took.value
    lstm_kernel.launches = 0
    k2.launches = 0
    flush_ms, host_ms, n_events, busy_s = [], [], 0, 0.0
    for label, ticks, anomalous in plan:
        t0 = time.perf_counter()
        for batch, _ in ticks:
            path.ingest(batch)
        t1 = time.perf_counter()
        scored = await path.session.flush()
        t2 = time.perf_counter()
        busy_s += t2 - t0
        flush_ms.append(1e3 * (t2 - t1))
        host_ms.append(1e3 * (t1 - t0))
        dev = np.concatenate([b.device_index for b, _ in ticks])
        val = np.concatenate([b.value for b, _ in ticks])
        n_events += dev.shape[0]
        check_scored(f"stream {label}", scored, dev)
        for lo in range(0, dev.shape[0], BUCKETS[-1]):
            expect += occurrence_rounds(dev[lo:lo + BUCKETS[-1]])
        pos, want = ref.step(dev, val)
        err = check_close(f"stream {label}", scored.score[pos], want)
        log(f"stream: flush {label}: {dev.shape[0]} events in "
            f"{flush_ms[-1]:.3f} ms, {pos.shape[0]} sampled events, max "
            f"|err| vs the CPU reference {err:.3e}")
        if anomalous:
            check_anomalies("stream", scored.score, ticks[0][1])
            anomalous_tick, full_scored = ticks[0][0], scored
        elif label == "fleet":
            sparse.ingest(ticks[0][0])
            await sparse.session.flush()
    launches = lstm_kernel.launches
    n_dispatch = int(dispatches.value - d0)
    n_k2 = int(took.value - k0)
    n_sparse = int(sparse_dispatches.value - sd0)
    n_sparse_k2 = int(sparse_took.value - sk0)
    # every dispatch of either session one launch of K2, and the counter
    # of each the dispatches that launched it
    if (n_dispatch != expect or launches or n_k2 != n_dispatch
            or n_sparse_k2 != n_sparse
            or k2.launches != n_dispatch + n_sparse):
        raise AssertionError(f"stream: {n_dispatch} dispatches for {expect} "
                             f"occurrence rounds, {launches} K1 launches, "
                             f"{k2.launches} K2 launches for {n_dispatch} + "
                             f"{n_sparse} (sparse) dispatches, counted "
                             f"{n_k2} + {n_sparse_k2}")
    await path.session.drain()
    stats = path_stats(flush_ms, host_ms, n_events, busy_s, n_dispatch,
                       launches)
    log(f"stream: {json.dumps(stats)}")

    # the sparse twin has seen the same fleet ticks: the anomaly tick's
    # reported set is the full readback's {score >= threshold}, apart
    # from what top-k overflow (counted) leaves out
    sparse.ingest(anomalous_tick)
    t1 = time.perf_counter()
    got = await sparse.session.flush()
    sparse_ms = 1e3 * (time.perf_counter() - t1)
    overflow = int(sparse.session.anomaly_overflow.value)
    full = dict(zip(full_scored.device_index[full_scored.is_anomaly].tolist(),
                    full_scored.score[full_scored.is_anomaly].tolist()))
    missing = set(full) - set(got.device_index.tolist())
    # the device compares the float32 score with the bar and the host the
    # float16 readback: a score within one float16 ulp of the bar may
    # fall on either side
    edge = np.abs(full_scored.score - THRESHOLD) <= 4e-3
    n_edge = int(edge.sum())
    bad = [d for d, v in zip(got.device_index.tolist(), got.score.tolist())
           if abs(full.get(d, THRESHOLD) - v) > (1e-3 if d in full else 4e-3)]
    if (bad or len(missing) > overflow + n_edge
            or abs(len(got) + overflow - len(full)) > n_edge
            or got.total_scored != FLEET):
        raise AssertionError(
            f"stream sparse: {len(bad)} reported outside the full set, "
            f"{len(missing)} missing vs overflow {overflow} ({n_edge} at "
            f"the bar), total_scored {got.total_scored}")
    log(f"stream sparse: {len(got)} anomalies reported + {overflow} "
        f"overflow, {len(full)} full-readback scores >= {THRESHOLD} "
        f"({n_edge} within a float16 ulp of it); flush {sparse_ms:.3f} ms")
    stats["sparse"] = {"reported": len(got), "overflow": overflow,
                       "full_set": len(full), "flush_ms": sparse_ms}
    path.session.close()
    sparse.session.close()
    return stats


async def drive_pool(torch, label: str, model: str, tenants: int,
                     devices: int, buckets: tuple, fleet_ticks: int,
                     anomalies: bool = True, dtype=None) -> dict:
    """`fleet_ticks` fleet ticks then an anomaly tick through a pool,
    every tenant one tick a flush, checked against a CPU reference (the
    anomalies must stand out unless `anomalies` is off: a forecaster's
    score is a forecast). `dtype` sets the model's compute dtype (bf16
    unless named) on the card and the CPU. Times the host side of each
    dispatch (the pool's `scoring.dispatch` step)."""
    from sitewhere_tpu_torch.convert import params_from_numpy, params_to_numpy
    from sitewhere_tpu_torch.models import build_model
    from sitewhere_tpu_torch.ops import lstm_kernel
    from sitewhere_tpu_torch.ops import lstm_stream_kernel as k2
    from sitewhere_tpu_torch.ops import tft_fused as k3
    from sitewhere_tpu_torch.tools import main_path

    t_setup = time.perf_counter()
    cfg = {} if dtype is None else {"compute_dtype": dtype}
    path = await main_path.build_pool("t", model, tenants, devices, buckets,
                                      **cfg)
    pool = path.pool
    window = path.model.cfg.window
    floor = (BF16_SHARE_FLOOR.get(model, {}).get(window) if dtype is None
             else None)
    rng = np.random.default_rng(SEED + 3)
    samples = {tid: np.sort(rng.choice(devices, min(SAMPLE, devices),
                                       replace=False))
               for tid in path.tenants}
    streaming = model == "lstm-stream"
    if streaming:
        refs = {tid: StreamReference(torch, m.params, m.store, samples[tid])
                for tid, m in path.tenants.items()}
    else:
        cpu_model = build_model(model, device="cpu",
                                **{**main_path.MODEL_CFG[model], **cfg})
        cpu_params = {tid: params_from_numpy(params_to_numpy(m.params), "cpu")
                      for tid, m in path.tenants.items()}
    dispatch_ms = time_calls(pool, "_dispatch")
    torch.cuda.synchronize()
    log(f"{label}: set-up (store fills, warmup) "
        f"{time.perf_counter() - t_setup:.3f} s")
    dispatches = path.metrics.counter("scoring.dispatches")
    took = path.metrics.counter("scoring.stream_kernel_dispatches")
    took3 = path.metrics.counter("scoring.tft_fused_dispatches")
    per_round = path.metrics.histogram("scoring.megabatch_tenants_per_dispatch")
    d0, k0, k30, expect = dispatches.value, took.value, took3.value, 0
    r0 = (per_round.count, per_round.sum)
    # K3's launches a forward at this model's widths (any rows, vmapped or
    # not: one launch an op call, one a recurrence step)
    per_forward = products_per_forward = 0
    if model == "tft":
        k3.launches = k3.product_launches = 0
        m = next(iter(path.tenants.values()))
        path.model.score(m.params, torch.zeros((8, window), device="cuda"),
                         torch.ones((8, window), dtype=torch.bool,
                                    device="cuda"))
        per_forward = k3.launches
        products_per_forward = k3.product_launches
    lstm_kernel.launches = 0
    k2.launches = 0
    k3.launches = k3.product_launches = 0
    flush_ms, host_ms, n_events, busy_s, shares = [], [], 0, 0.0, []
    for k in range(fleet_ticks + 1):
        anomalous = k == fleet_ticks
        t = path.t + TICK_S * k
        ticks = {tid: (anomaly_tick(m.sim, m.sim_cfg, t) if anomalous
                       else m.sim.tick(t=t))
                 for tid, m in path.tenants.items()}
        t0 = time.perf_counter()
        for tid, (batch, _) in ticks.items():
            path.ingest(tid, batch)
        t1 = time.perf_counter()
        scored = await path.flush()
        t2 = time.perf_counter()
        busy_s += t2 - t0
        flush_ms.append(1e3 * (t2 - t1))
        host_ms.append(1e3 * (t1 - t0))
        expect += max(occurrence_rounds(b.device_index)
                      for b, _ in ticks.values())
        errs = []
        for tid, (batch, truth) in ticks.items():
            dev, val = batch.device_index, batch.value
            n_events += dev.shape[0]
            check_scored(f"{label} {tid}", scored[tid], dev)
            if streaming:
                pos, want = refs[tid].step(dev, val)
            else:
                # the host store is the durable copy: the ring's windows
                # must equal its windows, and score like them on the CPU
                slot = pool.stack.slots[tid]
                pos = np.searchsorted(dev, samples[tid])
                x, valid = path.tenants[tid].store.window(samples[tid], window)
                rx, rv = pool.ring.windows(slot, samples[tid])
                rx, rv = rx.cpu().numpy(), rv.cpu().numpy()
                if not (np.array_equal(rv, valid)
                        and np.array_equal(rx[rv], x[valid])):
                    raise AssertionError(f"{label} {tid}: ring windows differ "
                                         "from the host store's")
                want = cpu_model.score(cpu_params[tid], torch.from_numpy(x),
                                       torch.from_numpy(valid)).numpy()
            if floor:
                shares.append(check_share(f"{label} {tid}",
                                          scored[tid].score[pos], want, floor))
                errs.append(shares[-1]["max_abs_err"])
            else:
                errs.append(check_close(f"{label} {tid}",
                                        scored[tid].score[pos], want))
            if anomalous and anomalies:
                check_anomalies(f"{label} {tid}", scored[tid].score, truth)
        log(f"{label}: flush {'anomalies' if anomalous else 'fleet'}: "
            f"{tenants} x {devices} events in {flush_ms[-1]:.3f} ms, max "
            f"|err| vs the CPU reference {max(errs):.3e}")
    launches = lstm_kernel.launches
    n_dispatch = int(dispatches.value - d0)
    n_k2 = int(took.value - k0)
    n_k3 = int(took3.value - k30)
    rounds = per_round.count - r0[0]
    packed = (per_round.sum - r0[1]) / max(rounds, 1)
    # every tenant admitted before each flush: each round packs them all;
    # lstm-stream launches K2 once a dispatch, the other models never, and
    # the counter follows the launches; every tft dispatch goes through K3
    k2_launches = k2.launches
    k3_launches = k3.launches
    k3_products = k3.product_launches
    if (n_dispatch != expect or launches or rounds != fleet_ticks + 1
            or packed != tenants or len(dispatch_ms) != n_dispatch
            or k2_launches != (n_dispatch if streaming else 0)
            or n_k2 != k2_launches
            or n_k3 != (n_dispatch if model == "tft" else 0)
            or k3_launches != n_dispatch * per_forward
            or k3_products != n_dispatch * products_per_forward
            or (model == "tft") != (per_forward > 0)
            or (model == "tft") != (products_per_forward > 0)):
        raise AssertionError(
            f"{label}: {n_dispatch} dispatches for {expect} occurrence "
            f"rounds, {launches} K1 launches, {k2_launches} K2 launches "
            f"({n_k2} counted), {n_k3} dispatches through K3 with "
            f"{k3_launches} K3 launches ({per_forward} a forward) and "
            f"{k3_products} fused products ({products_per_forward} a "
            f"forward), {rounds} "
            f"rounds packing {packed} tenants each, {len(dispatch_ms)} "
            f"timed")
    stats = path_stats(flush_ms, host_ms, n_events, busy_s, n_dispatch,
                       launches)
    stats["tenants_per_dispatch"] = packed
    stats["stream_kernel_dispatches"] = n_k2
    stats["stream_kernel_launches"] = k2_launches
    stats["tft_fused_dispatches"] = n_k3
    stats["tft_fused_launches"] = k3_launches
    stats["tft_fused_launches_per_forward"] = per_forward
    stats["tft_fused_product_launches"] = k3_products
    stats["tft_fused_products_per_forward"] = products_per_forward
    stats["dispatch_host_ms_p50"] = float(np.quantile(dispatch_ms, 0.5))
    stats["dispatch_host_ms_max"] = float(np.max(dispatch_ms))
    if shares:
        stats["bf16_sample_vs_cpu"] = shares
    log(f"{label}: {json.dumps(stats)}")
    pool.close()
    return stats


async def check_delivery(label: str, pipe, consumer, plan, got: list,
                         want: int, stored: int) -> list:
    """After a burst: the inbound group commits through the decoded
    topic's end, every event of `plan` lands on the scored topic exactly
    once (no record after the expected ones: a double delivery),
    telemetry holds `stored` events, every score is finite and the
    anomalous tick stands out. Returns each tick's scores in the plan's
    order."""
    from sitewhere_tpu_torch.tools import pipeline as pl

    deadline = time.monotonic() + 60.0
    while pipe.inbound_lag():
        if time.monotonic() > deadline:
            raise AssertionError(f"{label}: the inbound group lags "
                                 f"{pipe.inbound_lag()} records")
        await asyncio.sleep(0.01)
    await asyncio.sleep(0.2)
    got += [rec.value for rec in consumer.poll_nowait(max_records=4096)]
    table = pl.scored_table(got)
    keys = {(d, ts) for batch, _ in plan
            for d, ts in zip(batch.device_index.tolist(), batch.ts.tolist())}
    twice = sum(1 for v in table.values() if v[2] > 1)
    if set(table) != keys or twice or sum(map(len, got)) != want:
        raise AssertionError(
            f"{label}: {len(table)} scored keys for {len(keys)} events, "
            f"{twice} delivered twice, {sum(map(len, got))} records")
    if pipe.em.telemetry.total_events != stored:
        raise AssertionError(f"{label}: telemetry holds "
                             f"{pipe.em.telemetry.total_events} events, "
                             f"not {stored}")
    scores = [np.array([table[k][0] for k in zip(
        batch.device_index.tolist(), batch.ts.tolist())], np.float32)
        for batch, _ in plan]
    if not all(np.isfinite(sc).all() for sc in scores):
        raise AssertionError(f"{label}: a score is not finite")
    check_anomalies(label, scores[PIPELINE_ANOMALY_AT],
                    plan[PIPELINE_ANOMALY_AT][1])
    return scores


def check_stream_sample(label: str, ref, plan, scores) -> float:
    """Step the CPU reference over every tick of `plan` in order and
    hold the sampled devices' scores to it; returns the max |err|."""
    errs = []
    for (batch, _), sc in zip(plan, scores):
        pos, want = ref.step(batch.device_index, batch.value)
        errs.append(check_close(label, sc[pos], want))
    return max(errs)


def check_window_session(torch, label: str, pipe, sample: np.ndarray,
                         last_scores: np.ndarray) -> float:
    """The store is the durable copy: its windows, which end at the last
    tick, must equal the dedicated session's ring windows and score like
    them through K1's plain version; returns the max |err|."""
    session = pipe.engine.session
    x, valid = pipe.em.telemetry.window(sample, WINDOW)
    rx, rv = session.ring.windows(sample)
    rx, rv = rx.cpu().numpy(), rv.cpu().numpy()
    if not (np.array_equal(rv, valid) and np.array_equal(rx[rv], x[valid])):
        raise AssertionError(f"{label}: ring windows differ from the store's")
    dev = session.ring.device
    ref_sc = plain_scores(torch, session.model, session.params,
                          torch.from_numpy(x).to(dev),
                          torch.from_numpy(valid).to(dev))
    return check_close(label, last_scores[sample],
                       ref_sc.float().cpu().numpy())


async def phase_pipeline(torch, label: str, model: str, megabatch: bool,
                         data_dir: str | None = None):
    """The bench's deployment through the service runtime: six fleet
    ticks submitted to the tenant's receiver, scored through the fast
    lane, the pool (or a dedicated session) and the egress stage, with a
    durable log and registry snapshots under `data_dir` when it is set.
    Returns (stats, the stopped pipeline)."""
    from sitewhere_tpu_torch.ops import lstm_kernel
    from sitewhere_tpu_torch.tools import pipeline as pl

    t_setup = time.perf_counter()
    pipe = await pl.build(model, megabatch, data_dir=data_dir)
    eng, rt = pipe.engine, pipe.rt
    if (eng.fastlane is None or eng.egress is None
            or (eng.pool_slot is None) == megabatch):
        raise AssertionError(
            f"{label}: fast lane {eng.fastlane is not None}, egress "
            f"{eng.egress is not None}, pool slot {eng.pool_slot is not None}")
    rng = np.random.default_rng(SEED + 4)
    sample = np.sort(rng.choice(pl.FLEET, SAMPLE, replace=False))
    streaming = model == "lstm-stream"
    if streaming:
        params = (eng.pool_slot.pool.stack.get_params(pipe.tenant)
                  if megabatch else eng.session.params)
        ref = StreamReference(torch, params, pipe.em.telemetry, sample)
    plan = pl.ticks(pipe, PIPELINE_TICKS, PIPELINE_ANOMALY_AT)
    payloads = [batch.encode() for batch, _ in plan]
    consumer = pipe.scored_consumer()
    torch.cuda.synchronize()
    log(f"{label}: set-up (runtime, fleet registry, store fill, warmup) "
        f"{time.perf_counter() - t_setup:.3f} s")

    dispatches = rt.metrics.counter("scoring.dispatches")
    per_round = rt.metrics.histogram("scoring.megabatch_tenants_per_dispatch")
    d0, r0 = dispatches.value, (per_round.count, per_round.sum)
    rt.metrics.histogram("scoring.e2e_latency_s").reset()
    want = PIPELINE_TICKS * pl.FLEET
    lstm_kernel.launches = 0
    t0 = time.monotonic()
    for payload in payloads:
        if not await pipe.receiver.submit(payload):
            raise AssertionError(f"{label}: a tick was shed at ingress")
    got, t_last = await pl.collect_scored(consumer, want)
    launches = lstm_kernel.launches
    n_dispatch = int(dispatches.value - d0)
    rounds = per_round.count - r0[0]
    packed = (per_round.sum - r0[1]) / rounds if rounds else None
    burst = pl.latency_ms(rt)

    stored = (WINDOW + 4 + PIPELINE_TICKS) * pl.FLEET
    scores = await check_delivery(label, pipe, consumer, plan, got, want,
                                  stored)
    if streaming:
        # every tick's sampled events against the CPU reference
        err = check_stream_sample(label, ref, plan, scores)
        if launches:
            raise AssertionError(f"{label}: {launches} K1 launches")
    else:
        err = check_window_session(torch, label, pipe, sample, scores[-1])
        if launches == 0 or launches != n_dispatch:
            raise AssertionError(f"{label}: K1 launches {launches} != "
                                 f"dispatches {n_dispatch}")
    if n_dispatch != PIPELINE_TICKS:
        raise AssertionError(f"{label}: {n_dispatch} dispatches for "
                             f"{PIPELINE_TICKS} fleet ticks")
    paced = await pace_pipeline(pipe, consumer, want / (t_last - t0))
    consumer.close()
    stats = {"events": want, "events_per_s": want / (t_last - t0),
             "burst": burst, "paced": paced, "dispatches": n_dispatch,
             "tenants_per_dispatch": packed, "kernel_launches": launches,
             "max_err": err, "stages": pl.stage_ms(rt)}
    log(f"{label}: {json.dumps(stats)}")
    await pipe.stop()
    return stats, pipe


async def pace_pipeline(pipe, consumer, burst_rate: float, send=None,
                        record: list | None = None) -> dict:
    """`scoring.e2e_latency_s` at a paced load, as the bench reads it
    (`bench.py:2569-2599`): PACED_TICKS more fleet ticks, one every
    FLEET / (PACED_FRACTION × the burst's events/s), so a tick does not
    queue behind the one before; every event scored, every score
    finite. Ticks go to the tenant's queue receiver, or through
    `send(batch)` (a protocol's gateways); `record` gets (ticks, scored
    batches)."""
    from sitewhere_tpu_torch.tools import pipeline as pl

    batches = [pipe.sim.tick(t=pipe.t + pl.TICK_S * (PIPELINE_TICKS + k))[0]
               for k in range(PACED_TICKS)]
    payloads = [b.encode() for b in batches] if send is None else batches
    interval = pl.FLEET / (PACED_FRACTION * burst_rate)
    pipe.rt.metrics.histogram("scoring.e2e_latency_s").reset()
    next_t = time.monotonic()
    for payload in payloads:
        if send is not None:
            await send(payload)
        elif not await pipe.receiver.submit(payload):
            raise AssertionError("paced: a tick was shed at ingress")
        next_t += interval
        await asyncio.sleep(max(0.0, next_t - time.monotonic()))
    got, _ = await pl.collect_scored(consumer, PACED_TICKS * pl.FLEET)
    if (sum(map(len, got)) != PACED_TICKS * pl.FLEET
            or not all(np.isfinite(b.score).all() for b in got)):
        raise AssertionError(f"paced: {sum(map(len, got))} scores for "
                             f"{PACED_TICKS * pl.FLEET} events, or not finite")
    if record is not None:
        record.append((batches, got))
    return {"ticks": PACED_TICKS, "interval_ms": 1e3 * interval,
            **pl.latency_ms(pipe.rt)}


def phase_demo() -> dict:
    """The port's CLI demo on the card with REST on a free port, its
    JSON report checked; while it runs, `GET /api/instance/health` must
    answer 200 with all fourteen services."""
    import contextlib
    import io
    import socket
    import threading
    import urllib.request

    from sitewhere_tpu_torch import cli, services as svc

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out, done = io.StringIO(), {}

    def run():
        try:
            with contextlib.redirect_stdout(out):
                done["rc"] = cli.main(["demo", "--devices", "4096",
                                       "--seconds", "3", "--port",
                                       str(port)])
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            done["error"] = exc

    thread = threading.Thread(target=run, name="demo")
    thread.start()
    health, t0 = None, time.monotonic()
    while health is None and thread.is_alive():
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/api/instance/health",
                    timeout=10) as resp:
                if resp.status == 200:
                    health = json.loads(resp.read())
                    health_s = time.monotonic() - t0
        except OSError:
            time.sleep(0.05)
    thread.join()
    if "error" in done:
        raise done["error"]
    rc, text = done["rc"], out.getvalue()
    report = json.loads(text[text.index("{"):])
    ids = {getattr(svc, name).identifier for name in cli.ALL_SERVICES}
    services = sorted({c["name"] for c in (health or {}).get(
        "children", [])} & ids)
    report["rest_health"] = {"status": (health or {}).get("status"),
                             "services": len(services),
                             "first_answer_s": health_s if health else None}
    log(f"demo: {json.dumps(report)}")
    if (rc != 0 or report["events_sent"] == 0
            or report["events_persisted"] != report["events_sent"]
            or report["model_alerts"] <= 0 or len(services) != 14):
        raise AssertionError(f"demo: exit {rc}, report {report}, services "
                             f"{services}")
    return report


def phase_native() -> dict:
    """The store's host library against its numpy plain versions, bit
    for bit, at the bench's store size."""
    from sitewhere_tpu_torch.persistence import telemetry as tel
    from sitewhere_tpu_torch.persistence.native import get_lib

    get_lib()  # load the library outside the timed appends
    rng = np.random.default_rng(SEED + 5)
    native = tel.TelemetryTable(NATIVE_HISTORY, FLEET)
    plain = tel.TelemetryTable(NATIVE_HISTORY, FLEET)
    every = np.arange(FLEET, dtype=np.uint32)
    append_ms = {"native": [], "plain": []}
    seen = np.zeros(FLEET, np.int64)
    # half of every tick lands on `hot` devices, ≈NATIVE_HISTORY events
    # each (64 at the full fleet): their rings wrap
    hot = max(FLEET // (2 * NATIVE_HISTORY), 1)
    for k in range(NATIVE_TICKS):
        # the other half over the whole fleet: in-batch duplicates
        dev = np.concatenate([rng.integers(0, FLEET, FLEET // 2),
                              rng.integers(0, hot, FLEET // 2)])
        dev = rng.permutation(dev).astype(np.uint32)
        val = rng.normal(20.0, 5.0, FLEET).astype(np.float32)
        ts = TICK_S * k + np.sort(rng.random(FLEET))
        seen += np.bincount(dev, minlength=FLEET)
        for name, append in (("native", native.append),
                             ("plain", lambda d, v, t: tel.append_plain(
                                 plain, d, v, t))):
            t0 = time.perf_counter()
            append(dev, val, ts)
            append_ms[name].append(1e3 * (time.perf_counter() - t0))
        for field in ("values", "ts", "cursor", "count"):
            if getattr(native, field).tobytes() != getattr(plain, field).tobytes():
                raise AssertionError(f"native: append tick {k}: {field} "
                                     "differs from the plain version")
    wraps = int((seen > NATIVE_HISTORY).sum())
    if wraps < hot:
        raise AssertionError(f"native: only {wraps} rings wrapped")
    t0 = time.perf_counter()
    got = (*native.window(every, WINDOW), native.window_ts(every, WINDOW),
           *native.latest(every))
    native_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    want = (*tel.window_plain(plain, every, WINDOW),
            tel.window_ts_plain(plain, every, WINDOW),
            *tel.latest_plain(plain, every))
    plain_ms = 1e3 * (time.perf_counter() - t0)
    for name, a, b in zip(("window", "valid", "window_ts", "latest value",
                           "latest ts"), got, want):
        if a.dtype != b.dtype or a.tobytes() != b.tobytes():
            raise AssertionError(f"native: {name} differs from the plain "
                                 "version")
    stats = {"devices": FLEET, "history": NATIVE_HISTORY,
             "ticks": NATIVE_TICKS, "events_per_tick": FLEET,
             "rings_wrapped": wraps,
             # the first tick also pays the tables' first-touch page faults
             "append_ms": float(np.median(append_ms["native"])),
             "append_plain_ms": float(np.median(append_ms["plain"])),
             "append_ms_ticks": append_ms["native"],
             "append_plain_ms_ticks": append_ms["plain"],
             "reads_ms": native_ms, "reads_plain_ms": plain_ms}
    log(f"native: bit-equal to the plain versions; {json.dumps(stats)}")
    return stats


def logged_events(data_dir: str) -> tuple[int, tuple]:
    """The bench tenant's durable log read back on its own: (records,
    (device_index, value, ts) of its measurements in log order)."""
    from sitewhere_tpu_torch.domain.batch import BatchContext, MeasurementBatch
    from sitewhere_tpu_torch.persistence.durable import RT_MEASUREMENTS, SegmentLog
    from sitewhere_tpu_torch.tools import pipeline as pl

    ctx = BatchContext(tenant_id=pl.TENANT, source="chip-smoke")
    log_dir = os.path.join(data_dir, "tenants", pl.TENANT, "events")
    records, cols = 0, ([], [], [])
    for rtype, payload in SegmentLog(log_dir).replay():
        records += 1
        if rtype == RT_MEASUREMENTS:
            b = MeasurementBatch.decode(payload, ctx)
            for col, arr in zip(cols, (b.device_index, b.value, b.ts)):
                col.append(arr)
    return records, tuple(np.concatenate(c) for c in cols)


async def phase_durable(torch, data_dir: str) -> int:
    """Phase 8 spilling to `data_dir`, then a restart on it; returns the
    events the durable log holds at the end."""
    from sitewhere_tpu_torch.ops import lstm_kernel
    from sitewhere_tpu_torch.persistence.durable import (
        load_snapshot,
        save_snapshot,
    )
    from sitewhere_tpu_torch.tools import pipeline as pl

    label = "pipeline-durable"
    stats, first = await phase_pipeline(torch, label, "lstm-stream", True,
                                        data_dir)
    spill = first.em.spi.durable
    persist = stats["stages"]["event-management.persist"]
    # two parts of a restart's work, timed alone: reading and decoding
    # the log (the store's replay also appends it), loading the registry
    t0 = time.perf_counter()
    records, (dev, _, ts) = logged_events(data_dir)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    snapshot = load_snapshot(os.path.join(data_dir, "tenants", pl.TENANT,
                                          "registry.snap"))
    snapshot_s = time.perf_counter() - t0
    log(f"{label}: burst {stats['events_per_s']} events/s, persist "
        f"{persist['mean_ms']} ms a tick ({persist['spans']} ticks), spill "
        f"written {spill.written} dropped {spill.dropped} write errors "
        f"{spill.write_errors}; the log holds {records} records, "
        f"{dev.shape[0]} events")
    if spill.write_errors or records != spill.written:
        raise AssertionError(f"{label}: {records} records on disk for "
                             f"{spill.written} written")
    sent = (PIPELINE_TICKS + PACED_TICKS) * pl.FLEET
    if not spill.dropped and dev.shape[0] != sent:
        raise AssertionError(f"{label}: {dev.shape[0]} of {sent} events "
                             "logged")

    lstm_kernel.launches = 0
    t0 = time.perf_counter()
    pipe = await pl.build("lstm-stream", True, data_dir=data_dir)
    ttr = time.perf_counter() - t0
    dm = pipe.rt.api("device-management").management(pl.TENANT)
    tel1, tel2 = first.em.telemetry, pipe.em.telemetry
    # and the registry snapshot that the first runtime's snapshotter
    # wrote once in set-up (collected on the loop, encoded and written in
    # an executor thread), timed alone on the restored registry
    t0 = time.perf_counter()
    registry = dm.spi.to_snapshot()
    collect_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as tmp:
        t0 = time.perf_counter()
        save_snapshot(os.path.join(tmp, "registry.snap"), registry)
        save_s = time.perf_counter() - t0
    log(f"{label}: restart ready in {ttr:.3f} s (time to recover): "
        f"restored_from {dm.restored_from}, {dm.spi.device_count()} "
        f"devices, {tel2.total_events} events replayed into the store; "
        f"alone, the log's read + decode takes {read_s:.3f} s, the "
        f"registry snapshot's load {snapshot_s:.3f} s, its collect "
        f"{collect_s:.3f} s and encode + write {save_s:.3f} s")
    if (dm.restored_from != "snapshot+wal" or snapshot is None
            or dm.spi.device_count() != pl.FLEET
            or tel2.total_events != dev.shape[0]):
        raise AssertionError(f"{label}: restored {dm.restored_from}, "
                             f"{dm.spi.device_count()} devices, "
                             f"{tel2.total_events} events")
    # every written event is back, per device in the first runtime's
    # order: its windows with the dropped ticks left out
    every = np.arange(pl.FLEET)
    x1, v1 = tel1.window(every, pl.HISTORY)
    keep = v1 & np.isin(tel1.channel(0).window_ts(every, pl.HISTORY),
                        np.unique(ts))
    k = int(tel2.channel(0).count.max())
    x2, v2 = tel2.window(every, k)
    if not (np.array_equal(keep.sum(1), v2.sum(1))
            and np.array_equal(x1[keep], x2[v2])):
        raise AssertionError(f"{label}: the restored windows differ from "
                             "the first runtime's")

    # one more tick through the restored pipeline, sampled against the
    # CPU reference seeded from the restored store
    rng = np.random.default_rng(SEED + 7)
    sample = np.sort(rng.choice(pl.FLEET, SAMPLE, replace=False))
    ref = StreamReference(torch, pipe.engine.pool_slot.pool.stack.get_params(
        pipe.tenant), tel2, sample)
    consumer = pipe.scored_consumer()
    batch, _ = pipe.sim.tick(
        t=first.t + TICK_S * (PIPELINE_TICKS + PACED_TICKS))
    if not await pipe.receiver.submit(batch.encode()):
        raise AssertionError(f"{label}: the tick was shed at ingress")
    got, _ = await pl.collect_scored(consumer, pl.FLEET)
    consumer.close()
    table = pl.scored_table(got)
    scores = np.array([table[key][0] for key in zip(
        batch.device_index.tolist(), batch.ts.tolist())], np.float32)
    pos, want = ref.step(batch.device_index, batch.value)
    err = check_close(label, scores[pos], want)
    if len(table) != pl.FLEET or lstm_kernel.launches:
        raise AssertionError(f"{label}: {len(table)} scored after the "
                             f"restart, {lstm_kernel.launches} K1 launches")
    await pipe.stop()
    records, (dev, _, _) = logged_events(data_dir)
    summary = {"time_to_recover_s": ttr, "log_read_s": read_s,
               "snapshot_load_s": snapshot_s,
               "snapshot_collect_s": collect_s, "snapshot_save_s": save_s,
               "restored_from": dm.restored_from,
               "restored_events": int(tel2.total_events - pl.FLEET),
               "spill_written": spill.written, "spill_dropped": spill.dropped,
               "persist_ms": persist["mean_ms"],
               "events_per_s": stats["events_per_s"],
               "max_err_after_restart": err, "logged_events": int(dev.shape[0])}
    log(f"{label}: {json.dumps(summary)}")
    return int(dev.shape[0])


async def phase_replay(torch) -> dict:
    """The bench's replay corpus in the cold tier, replayed through the
    pool on the card, checked, then timed; then the shadow gate."""
    from sitewhere_tpu_torch.history import DivergenceGateError, ReplayEngine
    from sitewhere_tpu_torch.ops import lstm_kernel
    from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore
    from sitewhere_tpu_torch.tools import replay_bench as rb

    label = "replay"
    with tempfile.TemporaryDirectory(prefix="smoke-replay-",
                                     dir=scratch_dir()) as root:
        store, cols, comp, comp_s = rb.corpus(root)
        log(f"{label}: compacted {comp['events']} events from "
            f"{comp['segments']} segment(s) into {comp['blocks']} blocks in "
            f"{comp_s:.3f} s ({comp['events'] / comp_s:.1f} events/s)")
        if comp["events"] != rb.EVENTS:
            raise AssertionError(f"{label}: {comp['events']} compacted")
        pool, model = rb.pool()
        params = model.init(torch.Generator().manual_seed(SEED + 6))
        engine = ReplayEngine(pool)
        try:
            stats = await replay_passes(torch, engine, store, cols, params)
            # the shadow gate over the whole corpus: one 60 s window holds
            # ≈2 events a device, below the streaming model's 8-event
            # scoring floor, so there every score is 0 under any params

            async def sink(_scored) -> None:
                return None

            slot = pool.register(rb.TENANT, TelemetryStore(), rb.THRESHOLD,
                                 sink, params=params)
            v0 = slot.version
            try:
                await engine.guard_swap(
                    slot, store, {k: {n: t + 0.5 for n, t in leaf.items()}
                                  for k, leaf in params.items()},
                    max_divergence=GATE_BAR)
                raise AssertionError(f"{label}: perturbed params promoted")
            except DivergenceGateError as exc:
                refused = exc.report
            if slot.version != v0:
                raise AssertionError(f"{label}: a refused swap bumped the "
                                     "version")
            _, promoted = await engine.guard_swap(
                slot, store, {k: dict(leaf) for k, leaf in params.items()},
                max_divergence=GATE_BAR)
            if not promoted["promoted"] or slot.version == v0:
                raise AssertionError(f"{label}: identical params refused")
            stats["gate"] = {
                "events": promoted["events"],
                "identical_max_abs": promoted["max_abs"],
                "perturbed_max_abs": refused["max_abs"],
                "perturbed_anomaly_flips": refused["anomaly_flips"],
                "bar": GATE_BAR}
            pool.unregister(rb.TENANT)
        finally:
            pool.close()
            store.close()
    if lstm_kernel.launches:
        raise AssertionError(f"{label}: {lstm_kernel.launches} K1 launches")
    stats["compact_events_per_s"] = comp["events"] / comp_s
    log(f"{label}: {json.dumps(stats)}")
    return stats


async def replay_passes(torch, engine, store, cols, params) -> dict:
    """One checked replay pass (cold: every bucket's first dispatch
    lands here), then REPLAY_TRIALS timed ones."""
    from sitewhere_tpu_torch.history import ScoreCollector
    from sitewhere_tpu_torch.ops import lstm_kernel
    from sitewhere_tpu_torch.tools import replay_bench as rb

    label = "replay"
    lstm_kernel.launches = 0
    collect = ScoreCollector()
    t0 = time.perf_counter()
    first = await engine.replay(rb.TENANT, store, rb.THRESHOLD, params=params,
                                collect=collect)
    cold_s = time.perf_counter() - t0
    dev_t, ts_t, sc_t, _ = collect.table()
    dev = np.concatenate([c[0] for c in cols])
    ts = np.concatenate([c[2] for c in cols])
    order = np.lexsort((dev, ts))
    # every corpus event scored exactly once, every score finite
    if (first["events"] != rb.EVENTS or collect.total != rb.EVENTS
            or not np.array_equal(dev_t, dev[order])
            or not np.array_equal(ts_t, ts[order])
            or not np.isfinite(sc_t).all()):
        raise AssertionError(f"{label}: {collect.total} scores for "
                             f"{rb.EVENTS} events")
    # a sample against the streaming model on the CPU, fed each sampled
    # device's records in log order from the ring's cold state
    rng = np.random.default_rng(SEED + 8)
    sample = np.sort(rng.choice(rb.DEVICES, SAMPLE, replace=False))
    ref = StreamReference(torch, params, None, sample)
    # the sampled devices' scores by (device, ts); a key two events share
    # (ts collide at float64's resolution) is left out of the comparison
    mine = np.isin(dev_t, sample)
    keys = list(zip(dev_t[mine].tolist(), ts_t[mine].tolist()))
    scores = dict(zip(keys, sc_t[mine].tolist()))
    shared = {k for k, n in Counter(keys).items() if n > 1}
    errs, compared = [], 0
    for bdev, bval, bts in cols:
        pos, want = ref.step(bdev, bval)
        got = np.array([scores[k] for k in zip(bdev[pos].tolist(),
                                               bts[pos].tolist())], np.float32)
        ok = np.array([k not in shared for k in zip(bdev[pos].tolist(),
                                                    bts[pos].tolist())])
        errs.append(check_close(label, got[ok], want[ok]))
        compared += int(ok.sum())
    log(f"{label}: checked pass {first['events']} events, "
        f"{first['windows']} windows in {cold_s:.3f} s; {len(sample)} "
        f"devices ({compared} events) vs the CPU reference: max |err| "
        f"{max(errs):.3e}")
    rates = []
    for _ in range(REPLAY_TRIALS):
        t0 = time.perf_counter()
        rep = await engine.replay(rb.TENANT, store, rb.THRESHOLD,
                                  params=params)
        elapsed = time.perf_counter() - t0
        if rep["events"] != rb.EVENTS or rep["scored"] != rb.EVENTS:
            raise AssertionError(f"{label}: a timed pass scored "
                                 f"{rep['scored']} of {rep['events']}")
        rates.append(rb.EVENTS / elapsed)
    return {"events": rb.EVENTS, "devices": rb.DEVICES,
            "windows": first["windows"], "checked_pass_s": cold_s,
            "replay_events_per_s": max(rates),
            "replay_events_per_s_median": float(np.median(rates)),
            "trials": rates, "max_err": max(errs),
            "anomalies": first["anomalies"]}


def phase_cli_replay(data_dir: str, logged: int) -> dict:
    """`cli replay` over the durable phase's directory on the card."""
    import contextlib
    import io

    from sitewhere_tpu_torch import cli
    from sitewhere_tpu_torch.tools import pipeline as pl

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["replay", "--data-dir", data_dir, "--tenant",
                       pl.TENANT])
    seconds = time.perf_counter() - t0
    text = out.getvalue()
    report = json.loads(text[text.index("{"):])
    log(f"cli-replay: exit {rc} in {seconds:.3f} s: {json.dumps(report)}")
    if rc != 0 or report["events"] != logged or report["scored"] != logged:
        raise AssertionError(f"cli-replay: exit {rc}, {report['events']} "
                             f"replayed for {logged} logged")
    return report


async def phase_longwin_512(torch, dtype=None) -> dict:
    """`longwin` at its class default window=512 on a dedicated session:
    LONGWIN_FLEET devices, buckets of at most 1,024 rows (one 1,024-row
    dispatch holds [1024, 4, 512, 512] float32 scores, 4.3 GB); two fleet
    ticks and an anomaly tick, the ring's windows equal to the store's, a
    sample against the CPU model on the store's windows: held to
    BF16_SHARE_FLOOR in bf16, row for row with `dtype` float32.
    Untrained `longwin` weights predict a quantile interval so narrow
    that ordinary points already score at the clip, so the anomalies are
    not required to stand out (as in the pool's longwin phase)."""
    from sitewhere_tpu_torch.convert import params_from_numpy, params_to_numpy
    from sitewhere_tpu_torch.kernel.metrics import MetricsRegistry
    from sitewhere_tpu_torch.models import build_model
    from sitewhere_tpu_torch.ops import lstm_kernel
    from sitewhere_tpu_torch.scoring.server import ScoringConfig, ScoringSession
    from sitewhere_tpu_torch.sim.simulator import DeviceSimulator
    from sitewhere_tpu_torch.tools import main_path

    cfg = {} if dtype is None else {"compute_dtype": dtype}
    label = "longwin-512" + ("" if dtype is None else "-float32")
    t_setup = time.perf_counter()
    scorer = build_model("longwin", **cfg)
    window = scorer.cfg.window
    floor = None if dtype is not None else BF16_SHARE_FLOOR["longwin"][window]
    sim_cfg = SimConfig(num_devices=LONGWIN_FLEET, seed=SEED)
    sim = DeviceSimulator(sim_cfg, tenant_id="longwin")
    store = main_path.filled_store(sim, LONGWIN_FLEET, window)
    metrics = MetricsRegistry()
    session = ScoringSession(scorer, store, metrics, ScoringConfig(
        buckets=LONGWIN_BUCKETS, capacity=LONGWIN_FLEET, threshold=THRESHOLD,
        seed=SEED))
    session.warmup()
    torch.cuda.reset_peak_memory_stats()
    path = main_path.MainPath(scorer, store, sim, sim_cfg, metrics, session,
                              "longwin", TICK_S * (window + 4))
    cpu_model = build_model("longwin", device="cpu", **cfg)
    cpu_params = params_from_numpy(params_to_numpy(session.params), "cpu")
    sample = np.sort(np.random.default_rng(SEED + 5).choice(
        LONGWIN_FLEET, SAMPLE, replace=False))
    dispatch_ms = time_calls(session, "_dispatch")
    dispatches = metrics.counter("scoring.dispatches")
    d0 = dispatches.value
    torch.cuda.synchronize()
    log(f"{label}: set-up (store fill of {window + 4} ticks, warmup) "
        f"{time.perf_counter() - t_setup:.3f} s")
    lstm_kernel.launches = 0
    flush_ms, host_ms, n_events, busy_s = [], [], 0, 0.0
    errs, shares = [], []
    for k in range(3):
        anomalous = k == 2
        t = path.t + TICK_S * k
        batch, _ = (anomaly_tick(sim, sim_cfg, t) if anomalous
                    else sim.tick(t=t))
        t0 = time.perf_counter()
        path.ingest(batch)
        t1 = time.perf_counter()
        scored = await session.flush()
        t2 = time.perf_counter()
        busy_s += t2 - t0
        flush_ms.append(1e3 * (t2 - t1))
        host_ms.append(1e3 * (t1 - t0))
        dev = batch.device_index
        n_events += dev.shape[0]
        check_scored(label, scored, dev)
        x, valid = store.window(sample, window)
        rx, rv = session.ring.windows(sample)
        rx, rv = rx.cpu().numpy(), rv.cpu().numpy()
        if not (np.array_equal(rv, valid) and np.array_equal(rx[rv], x[valid])):
            raise AssertionError(f"{label}: ring windows differ from the "
                                 "host store's")
        # the CPU holds its own O(W²) scores: 256 rows at a time
        want = np.concatenate([cpu_model.score(
            cpu_params, torch.from_numpy(x[i:i + 256]),
            torch.from_numpy(valid[i:i + 256])).numpy()
            for i in range(0, SAMPLE, 256)])
        got = scored.score[np.searchsorted(dev, sample)]
        if floor:
            shares.append(check_share(label, got, want, floor))
            errs.append(shares[-1]["max_abs_err"])
        else:
            errs.append(check_close(label, got, want))
        log(f"{label}: flush {'anomalies' if anomalous else 'fleet'}: "
            f"{dev.shape[0]} events in {flush_ms[-1]:.3f} ms, max |err| vs "
            f"the CPU {errs[-1]:.3e}")
    n_dispatch = int(dispatches.value - d0)
    if lstm_kernel.launches or n_dispatch != 3 * LONGWIN_FLEET // max(
            LONGWIN_BUCKETS):
        raise AssertionError(f"{label}: {n_dispatch} dispatches, "
                             f"{lstm_kernel.launches} K1 launches")
    await session.drain()
    stats = path_stats(flush_ms, host_ms, n_events, busy_s, n_dispatch, 0)
    stats["dispatch_host_ms_p50"] = float(np.quantile(dispatch_ms, 0.5))
    stats["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
    stats["max_abs_err"] = max(errs)
    if shares:
        stats["bf16_sample_vs_cpu"] = shares
    log(f"{label}: {json.dumps(stats)}")
    session.close()
    return stats


async def phase_forecast(torch) -> dict:
    """`forecast_device` with attention on a `tft` tenant of the service
    runtime on the card (TftConfig defaults, its dedicated session), for
    FORECAST_QUERIES devices, held against the CPU model on the same
    context-shifted windows."""
    from sitewhere_tpu_torch import services
    from sitewhere_tpu_torch.config import InstanceSettings, TenantConfig
    from sitewhere_tpu_torch.convert import params_from_numpy, params_to_numpy
    from sitewhere_tpu_torch.kernel.service import ServiceRuntime
    from sitewhere_tpu_torch.models import build_model
    from sitewhere_tpu_torch.sim.simulator import DeviceSimulator

    label = "forecast"
    rt = ServiceRuntime(InstanceSettings(instance_id="forecast"))
    for name in ("DeviceManagementService", "EventManagementService",
                 "RuleProcessingService"):
        rt.add_service(getattr(services, name)(rt))
    await rt.start()
    try:
        await rt.add_tenant(TenantConfig(tenant_id="fc", sections={
            "rule-processing": {"model": "tft", "buckets": [1024]}}))
        engine = rt.api("rule-processing").engine("fc")
        em = rt.api("event-management").management("fc")
        cpu_model = build_model("tft", device="cpu")
        w, ctx = cpu_model.cfg.window, cpu_model.cfg.context
        sim = DeviceSimulator(SimConfig(num_devices=FORECAST_FLEET,
                                        seed=SEED + 7), tenant_id="fc")
        for k in range(w + 4):
            em.telemetry.append_measurements(sim.tick(t=TICK_S * k)[0])
        cpu_params = params_from_numpy(
            params_to_numpy(engine.session.params), "cpu")
        devices = np.random.default_rng(SEED + 7).choice(
            FORECAST_FLEET, FORECAST_QUERIES, replace=False)
        query_ms, f_err, a_err = [], 0.0, 0.0
        for d in devices:
            t0 = time.perf_counter()
            got = await engine.forecast_device(int(d), include_attention=True)
            query_ms.append(1e3 * (time.perf_counter() - t0))
            x, valid = em.telemetry.window(np.asarray([d]), w)
            xs, vs = np.zeros_like(x), np.zeros_like(valid)
            xs[:, :ctx], vs[:, :ctx] = x[:, w - ctx:], valid[:, w - ctx:]
            want, attn = cpu_model.forecast_with_attention(
                cpu_params, torch.from_numpy(xs), torch.from_numpy(vs))
            want, attn = want[0].numpy(), attn[0].numpy()
            fc = np.asarray(got["forecast"], np.float32)
            at = np.asarray(got["attention"], np.float32)
            if fc.shape != want.shape or at.shape != attn.shape:
                raise AssertionError(f"{label}: shapes {fc.shape}/{at.shape}")
            if not (np.abs(fc - want) <= SCORE_ATOL
                    + SCORE_RTOL * np.abs(want)).all() \
                    or not (np.abs(at - attn) <= ATTN_ATOL).all():
                raise AssertionError(
                    f"{label}: device {d} vs the CPU: forecast max |err| "
                    f"{np.abs(fc - want).max()}, attention "
                    f"{np.abs(at - attn).max()}")
            f_err = max(f_err, float(np.abs(fc - want).max()))
            a_err = max(a_err, float(np.abs(at - attn).max()))
    finally:
        await rt.stop()
    stats = {"queries": len(query_ms),
             "query_ms_p50": float(np.quantile(query_ms, 0.5)),
             "query_ms_max": float(np.max(query_ms)),
             "forecast_max_abs_err": f_err, "attention_max_abs_err": a_err,
             "horizon": got["horizon"], "quantiles": got["quantiles"]}
    log(f"{label}: {json.dumps(stats)}")
    return stats


def maintenance_graph(n: int):
    """The bench's maintenance fleet (`tools.bench.maintenance_fleet`,
    `bench.py:1774-1802`): n devices, n/50 assets, n/200 areas under one
    site, W+4 ticks of telemetry; every 97th device carries an incident
    (the bench has none, so its loss has no positive class)."""
    from sitewhere_tpu_torch.models.graph import build_fleet_graph
    from sitewhere_tpu_torch.tools.bench import maintenance_fleet

    dm, store = maintenance_fleet(n, WINDOW, seed=SEED)
    return build_fleet_graph(dm, store, window=WINDOW,
                             failed_device_indices=np.arange(0, n, 97))


def phase_maintenance(torch) -> dict:
    """The GNN maintenance plane on the card at MAINT_SIZES devices:
    `MaintenanceTrainer.train` at its defaults, then risk scores per
    second (the bench's `gnn_fleet_risk_scores_per_sec`: `score` over
    the whole graph for at least MAINT_SECONDS), the risks held against
    the same params on the CPU."""
    from sitewhere_tpu_torch.convert import params_from_numpy, params_to_numpy
    from sitewhere_tpu_torch.training.maintenance import (
        MaintenanceTrainer,
        build_maintenance_model,
    )

    out = {}
    for n in MAINT_SIZES:
        label = f"maintenance-{n}"
        t0 = time.perf_counter()
        graph = maintenance_graph(n)
        build_s = time.perf_counter() - t0
        trainer = MaintenanceTrainer(build_maintenance_model())
        params, report = trainer.train(graph)
        torch.cuda.synchronize()
        risk = trainer.score(params, graph)  # warm at this graph's shape
        iters, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < MAINT_SECONDS:
            risk = trainer.score(params, graph)
            iters += 1
        elapsed = time.perf_counter() - t0
        cpu = MaintenanceTrainer(build_maintenance_model(device="cpu"))
        want = cpu.score(params_from_numpy(params_to_numpy(params), "cpu"),
                         graph)
        err = np.abs(risk - want)
        if (risk.shape != (n,) or not np.isfinite(risk).all()
                or not (err <= RISK_ATOL).all()
                or not report["losses"][-1] < report["losses"][0]):
            raise AssertionError(f"{label}: risk {risk.shape}, max |err| vs "
                                 f"the CPU {err.max()}, losses "
                                 f"{report['losses']}")
        out[n] = {"graph_build_s": build_s, "graph_nodes": graph.n_pad,
                  "train_steps": report["steps"],
                  "train_steps_per_s": report["steps"] / report["seconds"],
                  "losses": report["losses"],
                  "risk_scores_per_s": n * iters / elapsed,
                  "scoring_iters": iters, "max_abs_err_vs_cpu": float(
                      err.max())}
        log(f"{label}: {json.dumps(out[n])}")
    return out


def phase_train(ckpt: str) -> dict:
    """`cli train --model lstm-stream` at the CLI's defaults on the card,
    checkpointed under `ckpt`."""
    import contextlib
    import io

    from sitewhere_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["train", "--model", "lstm-stream", "--checkpoint",
                       ckpt])
    seconds = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    report = json.loads(lines[0])
    stats = {"exit": rc, "steps": report["steps"],
             "final_loss": report["final_loss"],
             "train_seconds": report["seconds"],
             "steps_per_s": report["steps"] / report["seconds"],
             "command_seconds": seconds, "checkpoint": lines[-1]}
    log(f"train: {json.dumps(stats)}")
    if (rc != 0 or not np.isfinite(report["final_loss"])
            or not lines[-1].endswith("/cli/lstm-stream/v1")):
        raise AssertionError(f"train: exit {rc}, {lines}")
    return stats


def phase_replay_candidate(data_dir: str, ckpt: str) -> dict:
    """`cli replay --model lstm-stream --candidate ckpt` on the durable
    phase's directory: the exit code must agree with the reported
    divergence against the bar (0 promoted, 1 refused)."""
    import contextlib
    import io

    from sitewhere_tpu_torch import cli
    from sitewhere_tpu_torch.tools import pipeline as pl

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["replay", "--data-dir", data_dir, "--tenant",
                       pl.TENANT, "--model", "lstm-stream", "--candidate",
                       ckpt])
    seconds = time.perf_counter() - t0
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    bar = report["max_divergence"]
    stats = {"exit": rc, "seconds": seconds, "events": report["events"],
             "max_abs": report["max_abs"], "bar": bar,
             "anomaly_flips": report["anomaly_flips"],
             "promoted": report["promoted"]}
    log(f"replay-candidate: {json.dumps(stats)}")
    if rc != (0 if report["max_abs"] <= bar else 1) \
            or report["promoted"] != (rc == 0) or not report["events"]:
        raise AssertionError(f"replay-candidate: exit {rc} for max |d| "
                             f"{report['max_abs']} against {bar}")
    return stats


class KafkaGateway:
    """A Kafka Produce v0 client (acks=1): each slice is one record, a
    `MeasurementBatch` in the bus's codec, on the tenant's decoded topic,
    always on partition `pid` (one partition a gateway keeps each of its
    devices in order). The batch's `ingest_monotonic` is stamped just
    before it is encoded: the e2e latency starts at the client."""

    def __init__(self, port: int, topic: str, pid: int, name: str):
        self.port, self.topic, self.pid, self.name = port, topic, pid, name
        self.corr = 0

    @staticmethod
    def _str(v: str) -> bytes:
        return struct.pack(">h", len(v)) + v.encode()

    async def call(self, api_key: int, body: bytes) -> bytes:
        self.corr += 1
        req = (struct.pack(">hhi", api_key, 0, self.corr)
               + self._str(self.name) + body)
        self.writer.write(struct.pack(">i", len(req)) + req)
        await self.writer.drain()
        size = struct.unpack(">i", await self.reader.readexactly(4))[0]
        resp = await self.reader.readexactly(size)
        if struct.unpack_from(">i", resp)[0] != self.corr:
            raise AssertionError(f"kafka {self.name}: correlation id")
        return resp[4:]

    async def connect(self) -> None:
        self.reader, self.writer = await asyncio.open_connection(
            "127.0.0.1", self.port)

    async def partitions(self) -> int:
        """Metadata v0 for the topic: its partition count."""
        resp = await self.call(3, struct.pack(">i", 1) + self._str(self.topic))
        off = 4
        for _ in range(struct.unpack_from(">i", resp)[0]):   # brokers
            off += 4
            off += 2 + struct.unpack_from(">h", resp, off)[0] + 4
        off += 4                                             # topics: 1
        err = struct.unpack_from(">h", resp, off)[0]
        off += 2 + 2 + struct.unpack_from(">h", resp, off + 2)[0]
        if err:
            raise AssertionError(f"kafka metadata: error {err}")
        return struct.unpack_from(">i", resp, off)[0]

    async def send(self, batch) -> None:
        from sitewhere_tpu_torch.kernel import codec
        from sitewhere_tpu_torch.kernel.kafka_endpoint import (
            encode_message_set,
        )

        batch.ctx.ingest_monotonic = time.monotonic()
        mset = encode_message_set([(0, batch.ctx.source.encode(),
                                    codec.encode(batch),
                                    int(time.time() * 1000))])
        resp = await self.call(0, struct.pack(">hii", 1, 5000, 1)
                               + self._str(self.topic)
                               + struct.pack(">iii", 1, self.pid, len(mset))
                               + mset)
        err = struct.unpack_from(">h", resp, len(resp) - 10)[0]
        if err:
            raise AssertionError(f"kafka produce: error {err}")

    async def close(self) -> None:
        self.writer.close()


class CoapGateway:
    """Confirmable CoAP POSTs through `coap_post` (a NON datagram may be
    dropped when the listener's socket buffer fills, so it cannot be
    held to every event exactly once). In-flight requests are shared
    out by `inflight`: 4 × ≈37 KB datagrams fit a 208 KiB socket buffer,
    sixteen would not."""

    def __init__(self, port: int, inflight: asyncio.Semaphore):
        self.port, self.inflight = port, inflight

    async def connect(self) -> None:
        pass

    async def send(self, payload: bytes) -> None:
        from sitewhere_tpu_torch.services.coap import CODE_CHANGED, coap_post

        async with self.inflight:
            code = await coap_post("127.0.0.1", self.port, "telemetry",
                                   payload)
        if code != CODE_CHANGED:
            raise AssertionError(f"coap: answered {code:#x}, not 2.04")

    async def close(self) -> None:
        pass


async def open_gateways(pipe, protocol: str, port: int) -> list:
    """GATEWAYS clients of `protocol`, gateway i on its own topic,
    routing key, destination or partition, all connected."""
    from sitewhere_tpu_torch.kernel.bus import TopicNaming
    from sitewhere_tpu_torch.sim.clients import make_sender

    if protocol == "kafka":
        topic = pipe.rt.naming.tenant_topic(pipe.tenant,
                                            TopicNaming.EVENT_SOURCE_DECODED)
        probe = KafkaGateway(port, topic, 0, "probe")
        await probe.connect()
        parts = await probe.partitions()
        await probe.close()
        gateways = [KafkaGateway(port, topic, i % parts, f"gw-{i}")
                    for i in range(GATEWAYS)]
    elif protocol == "coap":
        inflight = asyncio.Semaphore(COAP_INFLIGHT)
        gateways = [CoapGateway(port, inflight) for _ in range(GATEWAYS)]
    else:
        def own(i: int) -> dict:
            name = f"gw-{i}"
            return {"mqtt": {"topic": f"telemetry/{name}", "client_id": name},
                    "websocket": {"client_id": name},
                    "amqp": {"routing_key": f"telemetry/{name}"},
                    "stomp": {"destination": f"telemetry/{name}"}}[protocol]

        gateways = [make_sender(protocol, "127.0.0.1", port, **own(i))
                    for i in range(GATEWAYS)]
    for gw in gateways:
        await asyncio.wait_for(gw.connect(), 30.0)
    return gateways


def gateway_slices(batch, tenant: str) -> list:
    """A fleet tick cut into GATEWAYS slices of consecutive devices."""
    from sitewhere_tpu_torch.domain.batch import BatchContext, MeasurementBatch

    per = len(batch) // GATEWAYS
    return [MeasurementBatch(BatchContext(tenant_id=tenant, source=f"gw-{i}"),
                             batch.device_index[i * per:(i + 1) * per],
                             batch.mtype[i * per:(i + 1) * per],
                             batch.value[i * per:(i + 1) * per],
                             batch.ts[i * per:(i + 1) * per])
            for i in range(GATEWAYS)]


def tick_sender(gateways, protocol: str, tenant: str):
    """`send(batch)`: one fleet tick through every gateway at once."""
    async def send(batch) -> None:
        slices = gateway_slices(batch, tenant)
        await asyncio.gather(*(
            gw.send(sl if protocol == "kafka" else sl.encode())
            for gw, sl in zip(gateways, slices)))
    return send


async def add_ingress(pipe, protocols) -> dict:
    """One receiver of each protocol on the pipeline's tenant (and for
    kafka an endpoint on the runtime's bus); returns {protocol: (port,
    the receiver or endpoint)}."""
    from sitewhere_tpu_torch.kernel.kafka_endpoint import KafkaEndpoint

    engine = pipe.rt.api("event-sources").engine(pipe.tenant)
    out = {}
    for protocol in protocols:
        if protocol == "kafka":
            ep = KafkaEndpoint(pipe.rt.bus, flow=pipe.rt.flow,
                               naming=pipe.rt.naming)
            await ep.start()
            out[protocol] = (ep.port, ep)
            continue
        receiver = engine.add_receiver({"kind": protocol, "decoder": "swb1",
                                        "name": protocol})
        await receiver.start()
        out[protocol] = (receiver.port, receiver)
    return out


async def ingress_burst(torch, pipe, label: str, protocol: str, port: int,
                        consumer, stored: int, ref=None,
                        sample: np.ndarray | None = None,
                        paced: bool = False) -> tuple[dict, int]:
    """PIPELINE_TICKS fleet ticks (one anomalous) through GATEWAYS
    clients of `protocol`, each gateway sending its slice of every tick
    in order; the phase_pipeline checks on what comes out, the sample
    against `ref` (a streaming pool) or against K1's plain version on
    the store's windows (a windowed session). Returns (stats, events in
    the store)."""
    from sitewhere_tpu_torch.ops import lstm_kernel
    from sitewhere_tpu_torch.tools import pipeline as pl

    rt = pipe.rt
    plan = pl.ticks(pipe, PIPELINE_TICKS, PIPELINE_ANOMALY_AT)
    slices = [gateway_slices(batch, pipe.tenant) for batch, _ in plan]
    if protocol != "kafka":
        slices = [[sl.encode() for sl in tick] for tick in slices]
    gateways = await open_gateways(pipe, protocol, port)
    dispatches = rt.metrics.counter("scoring.dispatches")
    d0 = dispatches.value
    rt.metrics.histogram("scoring.e2e_latency_s").reset()
    rt.tracer._rings.clear()          # this protocol's spans only
    want = PIPELINE_TICKS * pl.FLEET
    lstm_kernel.launches = 0
    t0 = time.monotonic()

    async def gateway(i: int) -> None:
        for tick in slices:
            await gateways[i].send(tick[i])

    await asyncio.gather(*(gateway(i) for i in range(GATEWAYS)))
    send_s = time.monotonic() - t0
    got, t_last = await pl.collect_scored(consumer, want)
    launches = lstm_kernel.launches
    n_dispatch = int(dispatches.value - d0)
    burst = pl.latency_ms(rt)
    stages = pl.stage_ms(rt)
    stored += want
    scores = await check_delivery(label, pipe, consumer, plan, got, want,
                                  stored)
    if ref is not None:
        err = check_stream_sample(label, ref, plan, scores)
        if launches:
            raise AssertionError(f"{label}: {launches} K1 launches")
    else:
        err = check_window_session(torch, label, pipe, sample, scores[-1])
        if launches == 0 or launches != n_dispatch:
            raise AssertionError(f"{label}: K1 launches {launches} != "
                                 f"dispatches {n_dispatch}")
    if n_dispatch < PIPELINE_TICKS:
        raise AssertionError(f"{label}: {n_dispatch} dispatches for "
                             f"{PIPELINE_TICKS} fleet ticks")
    stats = {"events": want, "events_per_s": want / (t_last - t0),
             "send_s": send_s, "burst": burst, "dispatches": n_dispatch,
             "kernel_launches": launches, "max_err": err, "stages": stages}
    ticks = PIPELINE_TICKS
    if paced:
        record = []
        stats["paced"] = await pace_pipeline(
            pipe, consumer, want / (t_last - t0),
            send=tick_sender(gateways, protocol, pipe.tenant), record=record)
        batches, got = record[0]
        table = pl.scored_table(got)
        for batch in batches:
            pos, want_sc = ref.step(batch.device_index, batch.value)
            sc = np.array([table[(int(d), float(t))][0] for d, t in zip(
                batch.device_index[pos], batch.ts[pos])], np.float32)
            stats["paced"]["max_err"] = max(
                stats["paced"].get("max_err", 0.0),
                check_close(f"{label}-paced", sc, want_sc))
        stored += PACED_TICKS * pl.FLEET
        ticks += PACED_TICKS
    for gw in gateways:
        await asyncio.wait_for(gw.close(), 30.0)
    pipe.t += pl.TICK_S * ticks
    log(f"{label}: {json.dumps(stats)}")
    return stats, stored


async def unmask_cost(listener, pipe) -> dict:
    """The WebSocket listener's frame read (its per-byte unmask, as the
    JAX package has it) on one gateway message, host ms: a cost no
    span of the pipeline covers, since it runs before the receiver's."""
    payload = gateway_slices(pipe.sim.tick(t=0.0)[0], pipe.tenant)[0].encode()
    mask = b"\x5a\xa5\x0f\xf0"
    frame = (bytes([0x82, 0x80 | 127]) + len(payload).to_bytes(8, "big")
             + mask + bytes(c ^ mask[i % 4] for i, c in enumerate(payload)))
    times = []
    for _ in range(20):
        reader = asyncio.StreamReader()
        reader.feed_data(frame)
        t0 = time.perf_counter()
        _, _, got = await listener._read_frame(reader)
        times.append(1e3 * (time.perf_counter() - t0))
    if got != payload:
        raise AssertionError("websocket: a frame did not unmask")
    stats = {"bytes": len(payload), "ms_p50": float(np.median(times)),
             "ms_min": min(times)}
    log(f"ingress-websocket unmask: {json.dumps(stats)}")
    return stats


async def coap_non_burst(pipe) -> dict:
    """GATEWAYS of the port's `CoapSender` (NON datagrams, as `cli
    simulate --protocol coap` sends) each sending one gateway message at
    once to a bare `CoapListener`: how many arrive. A NON burst past the
    listener's socket buffer is dropped without a trace, which is why
    the ingress phase sends confirmable requests."""
    from sitewhere_tpu_torch.services.coap import CoapListener
    from sitewhere_tpu_torch.sim.clients import make_sender

    async def on_payload(payload, source) -> None:
        pass

    listener = CoapListener(on_payload)
    await listener.start()
    slices = gateway_slices(pipe.sim.tick(t=0.0)[0], pipe.tenant)
    senders = [make_sender("coap", "127.0.0.1", listener.port)
               for _ in range(GATEWAYS)]
    for sender in senders:
        await sender.connect()
    for sender, sl in zip(senders, slices):
        await sender.send(sl.encode())
    await asyncio.sleep(1.0)
    for sender in senders:
        await sender.close()
    await listener.stop()
    stats = {"sent": GATEWAYS, "bytes": len(slices[0].encode()),
             "received": listener.accepted}
    log(f"ingress-coap NON burst: {json.dumps(stats)}")
    return stats


def cli_exec(*args: str, stderr=asyncio.subprocess.PIPE):
    """`python -u -m sitewhere_tpu_torch.cli *args` from the checkout's
    root, its stdout piped (a coroutine giving the process)."""
    return asyncio.create_subprocess_exec(
        sys.executable, "-u", "-m", "sitewhere_tpu_torch.cli", *args,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=asyncio.subprocess.PIPE, stderr=stderr)


async def run_simulate(protocol: str, port: int, *flags: str):
    """`cli simulate` over `protocol` at `port`, SIMULATE_DEVICES for
    2 s: exit 0 and a report of the events sent; returns (sent, its
    stdout)."""
    proc = await cli_exec("simulate", "--protocol", protocol, "--port",
                          str(port), "--devices", str(SIMULATE_DEVICES),
                          "--seconds", "2", *flags)
    out, err = await asyncio.wait_for(proc.communicate(), 300.0)
    text = out.decode()
    m = re.search(rf"sent (\d+) events over {protocol}", text)
    if proc.returncode != 0 or m is None:
        raise AssertionError(f"cli simulate: exit {proc.returncode}, "
                             f"{text!r} {err.decode()[-2000:]}")
    return int(m.group(1)), text


async def simulate_over(pipe, port: int, stored: int) -> dict:
    """`python -m sitewhere_tpu_torch.cli simulate --protocol mqtt` as a
    subprocess against the live runtime: exit 0, and the events it
    reports sent are the events decoded from its topic and persisted."""
    from sitewhere_tpu_torch.kernel.bus import TopicNaming

    topic = "telemetry/sim"
    decoded = pipe.rt.bus.subscribe(pipe.rt.naming.tenant_topic(
        pipe.tenant, TopicNaming.EVENT_SOURCE_DECODED), group="smoke-simulate")
    t0 = time.monotonic()
    sent, text = await run_simulate("mqtt", port, "--rate", "20",
                                    "--topic", topic)
    deadline = time.monotonic() + 60.0
    while pipe.em.telemetry.total_events < stored + sent:
        if time.monotonic() > deadline:
            raise AssertionError(
                f"cli simulate: {pipe.em.telemetry.total_events - stored} "
                f"of {sent} events persisted")
        await asyncio.sleep(0.05)
    await asyncio.sleep(0.2)
    persisted = pipe.em.telemetry.total_events - stored
    from_topic = sum(len(r.value) for r in decoded.poll_nowait(
        max_records=1 << 20) if getattr(r.value, "ctx", None) is not None
        and r.value.ctx.source == f"mqtt:{topic}")
    decoded.close()
    stats = {"sent": sent, "persisted": persisted, "decoded": from_topic,
             "seconds": time.monotonic() - t0, "stdout": text.strip()}
    log(f"cli-simulate: {json.dumps(stats)}")
    if not sent or persisted != sent or from_topic != sent:
        raise AssertionError(f"cli simulate: {stats}")
    return stats


async def phase_ingress(torch) -> dict:
    """The bench's pipeline-stream deployment fed through every ingress:
    one receiver of each protocol on the tenant plus a Kafka endpoint on
    the runtime's bus, GATEWAYS clients a protocol, the protocols one
    after another; mqtt also paced; then `cli simulate` over mqtt."""
    from sitewhere_tpu_torch.tools import pipeline as pl

    t_setup = time.perf_counter()
    pipe = await pl.build("lstm-stream", True)
    endpoints = await add_ingress(pipe, INGRESS_PROTOCOLS)
    rng = np.random.default_rng(SEED + 5)
    sample = np.sort(rng.choice(pl.FLEET, SAMPLE, replace=False))
    ref = StreamReference(torch, pipe.engine.pool_slot.pool.stack.get_params(
        pipe.tenant), pipe.em.telemetry, sample)
    consumer = pipe.scored_consumer()
    stored = (WINDOW + 4) * pl.FLEET
    log(f"ingress: set-up (runtime, fleet registry, store fill, warmup, "
        f"{len(endpoints)} endpoints) {time.perf_counter() - t_setup:.3f} s")
    out = {}
    try:
        for protocol in INGRESS_PROTOCOLS:
            out[protocol], stored = await ingress_burst(
                torch, pipe, f"ingress-{protocol}", protocol,
                endpoints[protocol][0], consumer, stored, ref=ref,
                paced=protocol == "mqtt")
        consumer.close()
        out["websocket"]["unmask"] = await unmask_cost(
            endpoints["websocket"][1].listener, pipe)
        out["coap"]["non_burst"] = await coap_non_burst(pipe)
        out["cli-simulate"] = await simulate_over(
            pipe, endpoints["mqtt"][0], stored)
    finally:
        await endpoints["kafka"][1].stop()
        await pipe.stop()
    return out


async def phase_ingress_window(torch) -> dict:
    """The same GATEWAYS MQTT clients into the windowed `lstm` on a
    dedicated session: K1 inside the runtime, fed over MQTT."""
    from sitewhere_tpu_torch.tools import pipeline as pl

    t_setup = time.perf_counter()
    pipe = await pl.build("lstm", False)
    endpoints = await add_ingress(pipe, ("mqtt",))
    rng = np.random.default_rng(SEED + 6)
    sample = np.sort(rng.choice(pl.FLEET, SAMPLE, replace=False))
    consumer = pipe.scored_consumer()
    log(f"ingress-window: set-up {time.perf_counter() - t_setup:.3f} s")
    try:
        stats, _ = await ingress_burst(
            torch, pipe, "ingress-window", "mqtt", endpoints["mqtt"][0],
            consumer, (WINDOW + 4) * pl.FLEET, sample=sample)
        consumer.close()
    finally:
        await pipe.stop()
    return stats


# -- the platform: fourteen services driven through REST ----------------------

async def rest_call(port: int, method: str, path: str, body=None, *,
                    token: str | None = None, basic: str | None = None,
                    tenant: str | None = None):
    """One HTTP/1.1 request to the REST facade on its own connection:
    (status, JSON body)."""
    import base64

    reader, writer = await asyncio.wait_for(
        asyncio.open_connection("127.0.0.1", port), 30.0)
    payload = json.dumps(body).encode() if body is not None else b""
    lines = [f"{method} {path} HTTP/1.1", "Host: localhost",
             f"Content-Length: {len(payload)}"]
    if token:
        lines.append(f"Authorization: Bearer {token}")
    if basic:
        lines.append("Authorization: Basic "
                     + base64.b64encode(basic.encode()).decode())
    if tenant:
        lines.append(f"X-SiteWhere-Tenant: {tenant}")
    try:
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode() + payload)
        await writer.drain()
        status = int((await asyncio.wait_for(reader.readline(), 120.0))
                     .split()[1])
        length = 0
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            key, _, value = line.decode().partition(":")
            if key.strip().lower() == "content-length":
                length = int(value)
        data = await reader.readexactly(length) if length else b""
    finally:
        writer.close()
    return status, (json.loads(data) if data else None)


class LoopProbe:
    """The event loop's longest stall while it runs: a task that sleeps
    PROBE_S and records how late each wake-up came."""

    def __init__(self):
        self.max_s, self._task = 0.0, None

    async def _run(self):
        loop = asyncio.get_running_loop()
        while True:
            t = loop.time()
            await asyncio.sleep(PROBE_S)
            self.max_s = max(self.max_s, loop.time() - t - PROBE_S)

    def __enter__(self):
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    def __exit__(self, *exc):
        self._task.cancel()


async def platform_serve(rt, receiver, consumer, ticks, label: str):
    """Submit fleet ticks to the tenant's queue receiver and collect
    their scored records; K1 launches must equal the dispatches.
    Returns (scored batches, K1 launches)."""
    from sitewhere_tpu_torch.ops import lstm_kernel
    from sitewhere_tpu_torch.tools import pipeline as pl

    dispatches = rt.metrics.counter("scoring.dispatches")
    d0 = dispatches.value
    lstm_kernel.launches = 0
    for batch, _ in ticks:
        if not await receiver.submit(batch.encode()):
            raise AssertionError(f"{label}: a tick was shed at ingress")
    got, _ = await pl.collect_scored(consumer,
                                     sum(len(b) for b, _ in ticks))
    launches, n = lstm_kernel.launches, int(dispatches.value - d0)
    if launches == 0 or launches != n:
        raise AssertionError(f"{label}: K1 launches {launches} != "
                             f"dispatches {n}")
    if not all(np.isfinite(b.score).all() for b in got):
        raise AssertionError(f"{label}: a score is not finite")
    return got, launches


def platform_fleet(dm, n: int):
    """The platform tenant's fleet through `bootstrap_fleet`: n devices
    in areas of PLATFORM_AREA devices under one site (so the GNN sweep
    has a graph), dense indices 0..n-1."""
    from sitewhere_tpu_torch.domain.model import Area, DeviceType

    dt = DeviceType(token="thermo", name="Thermometer")
    site = dm.create_area(Area(token="site", name="Site"))
    for j in range(n // PLATFORM_AREA):
        area = dm.create_area(Area(token=f"area-{j}", name=f"Area {j}",
                                   parent_area_id=site.id))
        dm.bootstrap_fleet(dt, PLATFORM_AREA, token_prefix=f"dev-{j}",
                           area_id=area.id)
    return dt


async def phase_platform(torch) -> dict:
    """All fourteen services on the card, driven through the REST
    facade: auth, tenant CRUD, REST device CRUD timed, the windowed
    `lstm` served through K1, `POST /api/batch/train` hot-swapping the
    trained weights into the session, geofence alerts, the GNN
    maintenance sweep and an MQTT command round trip."""
    from sitewhere_tpu_torch.cli import build_runtime
    from sitewhere_tpu_torch.config import InstanceSettings
    from sitewhere_tpu_torch.convert import params_from_numpy, params_to_numpy
    from sitewhere_tpu_torch.domain.batch import BatchContext, LocationBatch
    from sitewhere_tpu_torch.domain.events import AlertLevel, DeviceAlert
    from sitewhere_tpu_torch.kernel.bus import TopicNaming
    from sitewhere_tpu_torch.models import build_model, graph as graph_mod
    from sitewhere_tpu_torch.services.geofence import points_in_polygon
    from sitewhere_tpu_torch.sim.clients import make_sender
    from sitewhere_tpu_torch.sim.simulator import DeviceSimulator
    from sitewhere_tpu_torch.tools import pipeline as pl
    from sitewhere_tpu_torch.training.checkpoint import CheckpointStore
    from sitewhere_tpu_torch.training.maintenance import (
        MaintenanceTrainer,
        build_maintenance_model,
    )

    n, tenant = PLATFORM_FLEET, "platform"
    out: dict = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="smoke-platform-",
                                     dir=scratch_dir()) as data_dir:
        rt = build_runtime(InstanceSettings(
            instance_id="platform", rest_port=0, data_dir=data_dir,
            flow_degrade_at=10.0, flow_defer_at=10.0), services=None)
        await rt.start()
        try:
            port = rt.services["instance-management"].rest.port

            # 1. auth
            status, _ = await rest_call(port, "GET", "/api/tenants")
            if status != 401:
                raise AssertionError(f"platform: no token answered {status}")
            status, doc = await rest_call(port, "POST", "/api/jwt",
                                          basic="admin:password")
            if status != 200:
                raise AssertionError(f"platform: POST /api/jwt {status}")
            tok = doc["token"]

            async def call(method, path, body=None, tenant_id=tenant,
                           expect=200):
                status, doc = await rest_call(port, method, path, body,
                                              token=tok, tenant=tenant_id)
                if status != expect:
                    raise AssertionError(f"platform: {method} {path} "
                                         f"answered {status}: {doc}")
                return doc

            # 2. the tenant: the bench's windowed lstm at full width on a
            # dedicated session, one geofence, MQTT ingress and downlink
            t0 = time.perf_counter()
            await call("POST", "/api/tenants", {
                "token": tenant, "name": "Platform", "sections": {
                    "egress": {"fused": True, "lanes": 1,
                               "autotune": False},
                    "event-management": {"history": pl.HISTORY},
                    "event-sources": {"receivers": [
                        {"kind": "queue", "decoder": "swb1",
                         "name": "default"},
                        {"kind": "mqtt", "decoder": "swb1",
                         "name": "mqtt"}]},
                    "command-delivery": {"provider": "mqtt",
                                         "encoder": "json"},
                    "batch-operations": {"checkpoint_root": os.path.join(
                        data_dir, "checkpoints")},
                    "rule-processing": {
                        "model": "lstm", "model_config": {"window": WINDOW},
                        "threshold": THRESHOLD, "batch_window_ms": 2.0,
                        "buckets": [n], "capacity": n, "max_inflight": 8,
                        "readback": "full", "shared": False,
                        "megabatch": {"enabled": False},
                        "geofences": [{"zone": "dock", "alert_on": "both",
                                       "level": "warning"}]}}})
            await call("POST", "/api/tenants", {
                "token": "rest", "sections": {"rule-processing": {
                    "model": None}}}, tenant_id=None)
            create_s = time.perf_counter() - t0
            dm = rt.api("device-management").management(tenant)
            em = rt.api("event-management").management(tenant)
            engine = rt.api("rule-processing").engine(tenant)
            session = engine.session
            if session is None or "geofence" not in engine.hooks:
                raise AssertionError("platform: no dedicated session or "
                                     "no geofence hook")
            t0 = time.perf_counter()
            platform_fleet(dm, n)
            deadline = time.monotonic() + 300.0
            while not (session.ready and dm.snapshot_current):
                if time.monotonic() > deadline:
                    raise AssertionError("platform: warmup or the registry "
                                         "snapshot not done")
                await asyncio.sleep(0.01)
            fleet_s = time.perf_counter() - t0

            # REST CRUD timed on a second tenant (its devices stay out of
            # the scored fleet's dense indices)
            await call("POST", "/api/devicetypes",
                       {"token": "meter", "name": "Meter"}, "rest")
            post_ms, get_ms = [], []
            for i in range(PLATFORM_REST_DEVICES):
                t0 = time.perf_counter()
                doc = await call("POST", "/api/devices",
                                 {"token": f"m-{i}", "deviceType": "meter"},
                                 "rest")
                post_ms.append(1e3 * (time.perf_counter() - t0))
                t0 = time.perf_counter()
                back = await call("GET", f"/api/devices/m-{i}",
                                  tenant_id="rest")
                get_ms.append(1e3 * (time.perf_counter() - t0))
                if back != doc or back["index"] != i:
                    raise AssertionError(f"platform: device m-{i} read "
                                         f"back {back}, wrote {doc}")
            out["rest"] = {
                "tenant_create_s": create_s, "fleet_register_s": fleet_s,
                "requests": 2 * PLATFORM_REST_DEVICES,
                "post_device_p50_ms": float(np.percentile(post_ms, 50)),
                "post_device_p99_ms": float(np.percentile(post_ms, 99)),
                "get_device_p50_ms": float(np.percentile(get_ms, 50)),
                "get_device_p99_ms": float(np.percentile(get_ms, 99))}
            log(f"platform-rest: {json.dumps(out['rest'])}")

            # 3. serve: W+4 ticks through the queue receiver
            sim_cfg = SimConfig(num_devices=n, seed=SEED)
            sim = DeviceSimulator(sim_cfg, tenant_id=tenant)
            receiver = rt.api("event-sources").engine(tenant) \
                .receiver("default")
            consumer = rt.bus.subscribe(rt.naming.tenant_topic(
                tenant, TopicNaming.SCORED_EVENTS), group="smoke-scored")
            warm = [sim.tick(t=TICK_S * k) for k in range(WINDOW + 4)]
            t0 = time.perf_counter()
            _, launches = await platform_serve(rt, receiver, consumer, warm,
                                               "platform-serve")
            serve_s = time.perf_counter() - t0
            out["serve"] = {"ticks": len(warm), "events": len(warm) * n,
                            "events_per_s": len(warm) * n / serve_s,
                            "kernel_launches": launches}
            log(f"platform-serve: {json.dumps(out['serve'])}")

            # 4. train through REST; the loop stall it causes is measured
            rng = np.random.default_rng(SEED + 7)
            sample = np.sort(rng.choice(n, SAMPLE, replace=False))
            before = params_to_numpy(session.params)
            v0 = session.version
            with LoopProbe() as probe:
                t0 = time.perf_counter()
                op = await call("POST", "/api/batch/train", {
                    "model": "lstm", "steps": PLATFORM_TRAIN_STEPS,
                    "batchSize": PLATFORM_TRAIN_BATCH})
                while op["processing_status"] in ("processing",
                                                  "initializing"):
                    await asyncio.sleep(0.05)
                    op = await call("GET", f"/api/batch/{op['id']}")
                op_s = time.perf_counter() - t0
            result = op["parameters"].get("result", {})
            losses = result.get("losses", [])
            if (op["processing_status"] != "finished"
                    or result.get("hot_swapped") is not True
                    or result.get("checkpoint_version") != 1
                    or not losses or not np.isfinite(losses).all()
                    or not losses[-1] < losses[0]
                    or session.version != v0 + 1):
                raise AssertionError(
                    f"platform-train: {op['processing_status']}, result "
                    f"{ {k: v for k, v in result.items() if k != 'losses'} }"
                    f", losses {losses}, version {v0} → {session.version}")
            out["train"] = {
                "steps": result["steps"], "windows": result["windows"],
                "batch": PLATFORM_TRAIN_BATCH,
                "train_seconds": result["train_seconds"],
                "steps_per_s": result["steps"] / result["seconds"],
                "first_loss": losses[0], "final_loss": losses[-1],
                "loop_stall_s": probe.max_s, "op_seconds": op_s}
            log(f"platform-train: {json.dumps(out['train'])}")

            # 5. score with the trained weights: K1 on the next ticks, a
            # sample against the CPU model on the checkpoint's params
            after = [sim.tick(t=TICK_S * (WINDOW + 4 + k)) for k in range(2)]
            got, launches = await platform_serve(rt, receiver, consumer,
                                                 after, "platform-swapped")
            table = pl.scored_table(got)
            last, _ = after[-1]
            ts = dict(zip(last.device_index.tolist(), last.ts.tolist()))
            served = np.array([table[(int(d), ts[int(d)])][0]
                               for d in sample], np.float32)
            params, meta = CheckpointStore(os.path.join(
                data_dir, "checkpoints")).load(tenant, "lstm")
            if meta["version"] != 1:
                raise AssertionError(f"platform: checkpoint {meta}")
            cpu = build_model("lstm", device="cpu", window=WINDOW)
            x, valid = em.telemetry.window(sample, WINDOW)
            xt, vt = torch.from_numpy(x), torch.from_numpy(valid)
            with torch.no_grad():
                want = cpu.score_fused(params_from_numpy(params, "cpu"),
                                       xt, vt).float().numpy()
                old = cpu.score_fused(params_from_numpy(before, "cpu"),
                                      xt, vt).float().numpy()
            err = check_close("platform-swapped", served, want)
            old_ref = old.astype(np.float16).astype(np.float32)
            moved = float(np.mean(np.abs(served - old_ref)
                                  > SCORE_ATOL + SCORE_RTOL
                                  * np.abs(old_ref)))
            if moved < 0.5:
                raise AssertionError(f"platform-swapped: only {moved:.3f} "
                                     "of the sample moved from the "
                                     "pre-swap weights")
            out["swapped"] = {"kernel_launches": launches,
                              "max_err_vs_cpu_checkpoint": err,
                              "share_moved_from_pre_swap": moved}
            log(f"platform-swapped: {json.dumps(out['swapped'])}")

            # 6. geofence: a zone over REST, a seeded subset moved in,
            # half of it out and another subset in, then everyone out
            await call("POST", "/api/zones", {
                "token": "dock", "name": "Dock",
                "bounds": [[10.0, 10.0], [10.0, 20.0], [20.0, 20.0],
                           [20.0, 10.0]]})
            geo = np.random.default_rng(SEED + 8)
            poly = np.asarray([[10.0, 10.0], [10.0, 20.0], [20.0, 20.0],
                               [20.0, 10.0]])
            devices = np.arange(n, dtype=np.uint32)
            subset = geo.choice(n, PLATFORM_GEO_SUBSET, replace=False)
            inside_sets = [subset, np.concatenate([
                subset[: PLATFORM_GEO_SUBSET // 2],
                geo.choice(np.setdiff1d(np.arange(n), subset),
                           PLATFORM_GEO_SUBSET // 2, replace=False)]),
                np.array([], np.int64)]
            was, enters, exits, moves = set(), 0, 0, []
            for k, inside in enumerate(inside_sets):
                lat = geo.uniform(40.0, 60.0, n)
                lon = geo.uniform(40.0, 60.0, n)
                lat[inside] = geo.uniform(11.0, 19.0, inside.shape[0])
                lon[inside] = geo.uniform(11.0, 19.0, inside.shape[0])
                now = set(np.nonzero(points_in_polygon(lat, lon, poly))[0]
                          .tolist())
                enters += len(now - was)
                exits += len(was - now)
                was = now
                moves.append(LocationBatch(
                    BatchContext(tenant_id=tenant, source="smoke"),
                    devices, lat, lon, np.zeros(n, np.float32),
                    np.full(n, TICK_S * (WINDOW + 10 + k))))

            def zone_alerts():
                counts = Counter(a.type for a in em.list_alerts(
                    limit=10 * n) if a.type.startswith("zone."))
                return counts["zone.enter"], counts["zone.exit"]

            t0 = time.perf_counter()
            for batch in moves:
                if not await receiver.submit(batch.encode()):
                    raise AssertionError("platform-geofence: shed")
            deadline = time.monotonic() + 120.0
            while zone_alerts() != (enters, exits):
                if time.monotonic() > deadline:
                    raise AssertionError(
                        f"platform-geofence: alerts {zone_alerts()}, "
                        f"numpy predicts {(enters, exits)}")
                await asyncio.sleep(0.02)
            geo_s = time.perf_counter() - t0
            await asyncio.sleep(0.5)
            if zone_alerts() != (enters, exits):
                raise AssertionError(f"platform-geofence: alerts "
                                     f"{zone_alerts()} past the prediction "
                                     f"{(enters, exits)}")
            out["geofence"] = {"location_events": len(moves) * n,
                               "enter": enters, "exit": exits,
                               "location_events_per_s":
                                   len(moves) * n / geo_s}
            log(f"platform-geofence: {json.dumps(out['geofence'])}")

            # 7. the GNN maintenance sweep through the batch-operations
            # API handle (no REST route), every 97th device an incident
            await em.add_alerts([DeviceAlert(
                device_id=d.id, type="incident", level=AlertLevel.ERROR,
                message="failed") for d in dm.list_devices(
                    page_size=n) if d.index % 97 == 0])
            seen: dict = {}
            real_graph, real_score = (graph_mod.build_fleet_graph,
                                      MaintenanceTrainer.score)

            def spy_graph(*a, **kw):
                seen["graph"] = real_graph(*a, **kw)
                return seen["graph"]

            def spy_score(self, params, graph):
                t = time.perf_counter()
                risk = real_score(self, params, graph)
                seen["score_s"] = time.perf_counter() - t
                seen["risk"] = risk
                return risk

            graph_mod.build_fleet_graph = spy_graph
            MaintenanceTrainer.score = spy_score
            try:
                ops = rt.api("batch-operations").operations(tenant)
                t0 = time.perf_counter()
                mop = await ops.submit_maintenance_operation(
                    window=WINDOW, label_alert_types=["incident"])
                mop = await ops.wait_for_operation(mop.id, timeout=600.0)
                maint_s = time.perf_counter() - t0
            finally:
                graph_mod.build_fleet_graph = real_graph
                MaintenanceTrainer.score = real_score
            report = mop.parameters.get("result", {})
            emitted = sum(1 for a in em.list_alerts(limit=10 * n)
                          if a.type == "maintenance.risk")
            gparams, gmeta = CheckpointStore(os.path.join(
                data_dir, "checkpoints")).load(tenant, "gnn")
            cpu_risk = MaintenanceTrainer(build_maintenance_model(
                device="cpu")).score(params_from_numpy(gparams, "cpu"),
                                     seen["graph"])
            risk = seen["risk"]
            rerr = np.abs(risk - cpu_risk)
            if (mop.processing_status.value != "finished"
                    or risk.shape != (n,) or report.get("devices") != n
                    or not (rerr <= RISK_ATOL).all()
                    or report.get("devices_at_risk") != emitted):
                raise AssertionError(
                    f"platform-maintenance: {mop.processing_status}, risk "
                    f"{risk.shape}, max |err| vs the CPU {rerr.max()}, at "
                    f"risk {report.get('devices_at_risk')} vs {emitted} "
                    f"alerts, report {report}")
            out["maintenance"] = {
                "devices": n, "edges": report["edges"],
                "labeled_failures": report["labeled_failures"],
                "train_steps_per_s": report["steps"] / report["seconds"],
                "risk_scores_per_s": n / seen["score_s"],
                "devices_at_risk": emitted, "op_seconds": maint_s,
                "max_abs_err_vs_cpu": float(rerr.max())}
            log(f"platform-maintenance: {json.dumps(out['maintenance'])}")

            # 8. command round trip: a device's MQTT client on its command
            # topic; the invocation over REST; its response back over
            # REST (no ingest protocol carries a response in either
            # package), read back through the invocation's responses
            device = "dev-0-7"
            mqtt_port = rt.api("event-sources").engine(tenant) \
                .receiver("mqtt").port
            client = make_sender("mqtt", "127.0.0.1", mqtt_port,
                                 client_id=device)
            await client.connect()
            # the sender only publishes: the SUBSCRIBE and the downlink
            # PUBLISH go over its connection's own reader and writer
            topic = f"swx/commands/{device}".encode()
            client._writer.write(client._packet(0x82, b"\x00\x07" + len(
                topic).to_bytes(2, "big") + topic + b"\x00"))   # SUBSCRIBE
            await client._writer.drain()
            suback = await asyncio.wait_for(client._reader.readexactly(5),
                                            10.0)
            if suback[0] != 0x90 or suback[4] == 0x80:
                raise AssertionError(f"platform-command: SUBACK {suback}")
            await call("POST", "/api/devicetypes/thermo/commands",
                       {"token": "reboot", "name": "reboot"})
            t0 = time.perf_counter()
            inv = await call("POST",
                             f"/api/assignments/{device}-a/invocations",
                             {"commandToken": "reboot",
                              "parameterValues": {"delay": 1}})
            head = await asyncio.wait_for(client._reader.readexactly(1), 10.0)
            length, mult = 0, 1
            while True:
                (b,) = await client._reader.readexactly(1)
                length += (b & 0x7F) * mult
                mult *= 128
                if not b & 0x80:
                    break
            body = await client._reader.readexactly(length)
            down_ms = 1e3 * (time.perf_counter() - t0)
            tlen = int.from_bytes(body[:2], "big")
            msg = json.loads(body[2 + tlen:])
            if (head[0] >> 4 != 3 or body[2:2 + tlen] != topic
                    or msg["invocation_id"] != inv["id"]
                    or msg["command"] != "reboot"):
                raise AssertionError(f"platform-command: got {head} "
                                     f"{body[:200]}")
            await call("POST", f"/api/assignments/{device}-a/responses",
                       {"originatingEventId": msg["invocation_id"],
                        "response": "rebooted"})
            resps = await call("GET",
                               f"/api/invocations/{inv['id']}/responses")
            rtt_ms = 1e3 * (time.perf_counter() - t0)
            await client.close()
            if [r["response"] for r in resps] != ["rebooted"]:
                raise AssertionError(f"platform-command: responses {resps}")
            out["command"] = {"downlink_ms": down_ms, "round_trip_ms": rtt_ms}
            log(f"platform-command: {json.dumps(out['command'])}")
            consumer.close()
        finally:
            await rt.stop()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"platform: {out['seconds']:.3f} s")
    return out


# -- the process split: the scorer in a process of its own --------------------

def ticks_window(ticks, devices: np.ndarray, w: int):
    """The last `w` readings of `devices` over `ticks` (fleet ticks of
    one channel, every device once each, oldest first), as the store's
    window gives them: ([D, w] float32, [D, w] valid), built from the
    batches this process sent and nothing the scorer returned."""
    cols = []
    for batch in ticks[-w:]:
        col = np.full(int(devices.max()) + 1, np.nan, np.float32)
        keep = batch.device_index <= devices.max()
        col[batch.device_index[keep]] = batch.value[keep]
        cols.append(col[devices])
    x = np.stack(cols, axis=1)
    if len(cols) != w or np.isnan(x).any():
        raise AssertionError(f"{len(cols)} ticks do not fill a window of "
                             f"{w} for every sampled device")
    return x, np.ones_like(x, bool)


async def phase_split(torch, label: str, model: str) -> dict:
    """`tools/split.py` at full width: the broker, event-sources and the
    simulator here, the five scoring services (K1 on the windowed
    session, or the `lstm-stream` pool) in a fresh interpreter on a
    `RemoteEventBus`; every event scored exactly once (read back over
    the broker), every consumer group of the tenant committed through
    the end offsets, finite scores, the anomalous tick standing out, K1
    launches == dispatches on the windowed session (0 on the pool), and
    SAMPLE devices against the CPU reference on the child's params and
    on windows built here from the ticks sent (the child's own store
    windows, written under `scratch_dir()`, must equal them)."""
    from types import SimpleNamespace

    from sitewhere_tpu_torch.convert import params_from_numpy
    from sitewhere_tpu_torch.models import build_model
    from sitewhere_tpu_torch.tools import pipeline as pl
    from sitewhere_tpu_torch.tools import split as sp
    from sitewhere_tpu_torch.training.checkpoint import CheckpointStore

    # the scorer process allocates on the same card
    torch.cuda.empty_cache()
    cfg = sp.SplitConfig(devices=FLEET, model=model, window=WINDOW,
                         burst_ticks=PIPELINE_TICKS,
                         anomaly_at=PIPELINE_ANOMALY_AT,
                         paced_ticks=PACED_TICKS)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="smoke-split-",
                                     dir=scratch_dir()) as d:
        report, rec = await sp.run(cfg, sample=SAMPLE, sample_dir=d)
        params, _ = CheckpointStore(d).load(sp.TENANT, model)
        with np.load(os.path.join(d, "windows.npz")) as win:
            sample, child_x, child_valid = (win["devices"], win["x"],
                                            win["valid"])
    # the pool's ring was seeded from the warm history before any tick;
    # the windowed session is sampled after the burst
    sent = [b for b, _ in rec["ticks"][:0 if cfg.pooled else PIPELINE_TICKS]]
    x, valid = ticks_window(sp.warm_ticks(cfg) + sent, sample, WINDOW)
    if not (np.array_equal(child_x, x) and np.array_equal(child_valid, valid)):
        raise AssertionError(f"{label}: the scorer's store windows differ "
                             f"from the ticks sent, max |diff| "
                             f"{np.nanmax(np.abs(child_x - x))}")
    table = pl.scored_table(rec["burst"] + rec["paced"])
    scores = [np.array([table[k][0] for k in zip(
        batch.device_index.tolist(), batch.ts.tolist())], np.float32)
        for batch, _ in rec["ticks"]]
    if not all(np.isfinite(sc).all() for sc in scores):
        raise AssertionError(f"{label}: a score is not finite")
    check_anomalies(label, scores[PIPELINE_ANOMALY_AT],
                    rec["ticks"][PIPELINE_ANOMALY_AT][1])
    launches, n_dispatch = report["kernel_launches"], report["dispatches"]
    params = params_from_numpy(params, "cpu")
    if model == "lstm-stream":
        store = SimpleNamespace(window=lambda devices, w: (x, valid))
        ref = StreamReference(torch, params, store, sample)
        err = check_stream_sample(label, ref, rec["ticks"], scores)
        if launches:
            raise AssertionError(f"{label}: {launches} K1 launches")
    else:
        # the last burst tick's scores
        cpu_model = build_model("lstm", device="cpu", window=WINDOW,
                                hidden=HIDDEN)
        ref_sc = plain_scores(torch, cpu_model, params, torch.from_numpy(x),
                              torch.from_numpy(valid))
        err = check_close(label, scores[PIPELINE_TICKS - 1][sample],
                          ref_sc.float().numpy())
        if launches == 0 or launches != n_dispatch:
            raise AssertionError(f"{label}: K1 launches {launches} != "
                                 f"dispatches {n_dispatch}")
    if n_dispatch < PIPELINE_TICKS + PACED_TICKS:
        raise AssertionError(f"{label}: {n_dispatch} dispatches for "
                             f"{PIPELINE_TICKS + PACED_TICKS} fleet ticks")
    stats = {**report, "max_err": err,
             "seconds": time.perf_counter() - t0}
    log(f"{label}: {json.dumps(stats)}")
    return stats


class CliProcess:
    """One `python -m sitewhere_tpu_torch.cli` process: its stdout read
    line by line with a deadline, its stderr kept in a file for the
    failure message, stopped by SIGTERM."""

    def __init__(self, *args: str):
        self.args = args
        self.err = tempfile.TemporaryFile(dir=scratch_dir())

    async def start(self) -> "CliProcess":
        self.proc = await cli_exec(*self.args, stderr=self.err)
        return self

    def tail(self) -> str:
        self.err.seek(0)
        return self.err.read().decode(errors="replace")[-3000:]

    async def expect(self, pattern: str, timeout: float = 300.0):
        deadline = time.monotonic() + timeout
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise AssertionError(f"cli {self.args[0]}: no {pattern!r} "
                                     f"in {timeout} s: {self.tail()}")
            line = await asyncio.wait_for(self.proc.stdout.readline(), left)
            if not line:
                raise AssertionError(
                    f"cli {self.args[0]}: exited {await self.proc.wait()} "
                    f"before {pattern!r}: {self.tail()}")
            m = re.search(pattern, line.decode())
            if m:
                return m

    async def stop(self, timeout: float = 60.0) -> int:
        if self.proc.returncode is None:
            self.proc.terminate()
        try:
            rc = await asyncio.wait_for(self.proc.wait(), timeout)
        except asyncio.TimeoutError:
            self.proc.kill()
            await self.proc.wait()
            raise AssertionError(f"cli {self.args[0]}: no exit {timeout} s "
                                 f"after SIGTERM: {self.tail()}") from None
        if rc != 0:
            raise AssertionError(f"cli {self.args[0]}: exit {rc} after "
                                 f"SIGTERM: {self.tail()}")
        return rc


async def phase_cli_split() -> dict:
    """The process split through the CLI: `serve-bus --port 0`; `run
    --bus` hosting the five scoring services with `--no-tenants` and an
    `--api-port` (on the card); `run --bus --services event-sources`
    with the default tenant and a TCP gateway; the fleet registered in
    the scoring process over its API port; `cli simulate` at the gateway
    for 2 s. Every event sent is persisted in the scoring process (read
    back over its API port), and SIGTERM stops all three with exit 0."""
    import socket

    from sitewhere_tpu_torch.domain.model import DeviceType
    from sitewhere_tpu_torch.kernel.wire import ApiChannel

    def free_port() -> int:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    t0 = time.monotonic()
    steps = {}  # seconds from the phase's start to each step's end
    mark = lambda step: steps.__setitem__(  # noqa: E731
        step, time.monotonic() - t0)
    api_port, gateway = free_port(), free_port()
    bus = await CliProcess("serve-bus", "--port", "0").start()
    procs = [bus]
    channel = None
    try:
        m = await bus.expect(r"bus broker on ([\d.]+):(\d+)", 60.0)
        mark("serve-bus")
        addr = f"{m.group(1)}:{m.group(2)}"
        scorer = await CliProcess(
            "run", "--bus", addr, "--services",
            "device-management,inbound-processing,event-management,"
            "device-state,rule-processing", "--no-tenants", "--api-port",
            str(api_port)).start()
        ingest = await CliProcess(
            "run", "--bus", addr, "--services", "event-sources",
            "--gateway-port", str(gateway)).start()
        procs += [scorer, ingest]
        await scorer.expect(r"instance .* up", 300.0)
        mark("scorer-run")
        await ingest.expect(r"instance .* up", 300.0)
        mark("ingest-run")
        channel = ApiChannel("127.0.0.1", api_port)
        await asyncio.gather(*(asyncio.wait_for(channel.wait_engine(
            service, "default", timeout=300.0), 310.0) for service in (
            "device-management", "event-management", "rule-processing")))
        mark("engines")
        await asyncio.wait_for(channel.call(
            "device-management", "bootstrap_fleet", tenant="default",
            args=[DeviceType(token="thermo", name="Thermometer"),
                  SIMULATE_DEVICES]), 120.0)
        mark("fleet")
        deadline = time.monotonic() + 60.0
        while True:  # the gateway listens once its engine is up
            try:
                _, w = await asyncio.open_connection("127.0.0.1", gateway)
                w.close()
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise AssertionError(f"cli split: no gateway on "
                                         f"{gateway}: {ingest.tail()}")
                await asyncio.sleep(0.1)
        mark("gateway")
        sent, _ = await run_simulate("tcp", gateway)
        mark("simulate")
        devices = np.arange(SIMULATE_DEVICES)
        deadline = time.monotonic() + 60.0
        while True:
            _, valid = await asyncio.wait_for(channel.call(
                "event-management", "window", tenant="default",
                sub="telemetry", args=[devices, WINDOW]), 60.0)
            persisted = int(valid.sum())
            if persisted >= sent or time.monotonic() > deadline:
                break
            await asyncio.sleep(0.1)
        mark("persisted")
    finally:
        if channel is not None:
            channel.close()
        # the two `run`s together, then their broker
        names = [" ".join(p.args[:1] + p.args[3:5]) for p in procs]
        rcs = dict(zip(names[1:], await asyncio.gather(
            *(p.stop() for p in procs[1:]))))
        rcs[names[0]] = await bus.stop()
    mark("stopped")
    stats = {"sent": sent, "persisted": persisted, "exit": rcs,
             "steps_s": steps, "seconds": time.monotonic() - t0}
    log(f"cli-split: {json.dumps(stats)}")
    if not sent or persisted != sent:
        raise AssertionError(f"cli split: {stats}")
    return stats



# -- the fleet: placement, handoff, a kill drill, the predictive planner -----

async def phase_fleet_window(torch) -> dict:
    """`tools/fleet.py` at full width: the broker, event-sources, the
    controller and the simulator here, two worker processes on the card
    (`tools.fleet.TENANTS` tenants of pipeline-window's windowed `lstm`, K1 on
    each tenant's dedicated session). W+4 warm ticks, then a burst of
    `tools.fleet.BURST_TICKS`: every event scored once (read back over the broker),
    the anomalous tick standing out, K1 launches == dispatches in each
    worker (its `stats` op), and SAMPLE devices (spread over the tenants)
    of the last burst tick against K1's plain version on the CPU, over
    the sessions' params (seed 0) and windows built here from the ticks
    sent; then the kill drill: 0 accepted events lost, the decoded
    backlog 0, every tenant group drained, the death detected within
    `fleet_dead_after_s` (plus the polling step), the replacement in."""
    from sitewhere_tpu_torch.models import build_model
    from sitewhere_tpu_torch.tools import fleet as fl
    from sitewhere_tpu_torch.tools.pipeline import scored_table

    import logging

    # the worker processes allocate on the same card
    torch.cuda.empty_cache()
    label = "fleet-window"
    # the run's steps and the controller's placement trail, in this log
    handler = logging.StreamHandler(sys.stdout)
    for name in ("sitewhere_tpu_torch.tools.fleet",
                 "sitewhere_tpu_torch.fleet"):
        logging.getLogger(name).setLevel(logging.INFO)
        logging.getLogger(name).addHandler(handler)
    cfg = fl.FleetConfig(devices=FLEET)
    t0 = time.perf_counter()
    report, rec = await fl.run(cfg)
    workers = report["burst_workers"]
    owned = [w for w, s in workers.items() if s["owned"]]
    if len(owned) < 2:
        raise AssertionError(f"{label}: placement used {owned} of {workers}")
    for wid, st in workers.items():
        if st["kernel_launches"] != st["dispatches"] \
                or bool(st["owned"]) != (st["dispatches"] > 0):
            raise AssertionError(f"{label}: worker {wid}: K1 launches "
                                 f"{st['kernel_launches']} != dispatches "
                                 f"{st['dispatches']} (owns {st['owned']})")
    cpu_model = build_model("lstm", device="cpu", window=fl.WINDOW,
                            hidden=HIDDEN)
    # a dedicated session's params: `model.init` from ScoringConfig.seed
    params = cpu_model.init(torch.Generator().manual_seed(0))
    warm_n = fl.WINDOW + 4
    rng = np.random.default_rng(SEED + 7)
    errs = []
    for tid in cfg.tenant_ids:
        ticks = rec["ticks"][tid]
        table = scored_table(rec["burst"][tid])
        scores = [np.array([table[k][0] for k in zip(
            b.device_index.tolist(), b.ts.tolist())], np.float32)
            for b, _ in ticks[warm_n:]]
        if not all(np.isfinite(sc).all() for sc in scores):
            raise AssertionError(f"{label} {tid}: a score is not finite")
        check_anomalies(f"{label} {tid}", scores[fl.ANOMALY_AT],
                        ticks[warm_n + fl.ANOMALY_AT][1])
        sample = np.sort(rng.choice(cfg.per_tenant, SAMPLE // fl.TENANTS,
                                    replace=False))
        x, valid = ticks_window([b for b, _ in ticks], sample, fl.WINDOW)
        ref = plain_scores(torch, cpu_model, params, torch.from_numpy(x),
                           torch.from_numpy(valid))
        errs.append(check_close(f"{label} {tid}", scores[-1][sample],
                                ref.float().numpy()))
    kill = report["kill"]
    if (kill["lost_accepted_events"] or kill["decoded_backlog_after_drain"]
            or not kill["death_detected"] or not kill["replacement_spawned"]
            or kill["detected_after_kill_s"] > fl.DEAD_AFTER_S
            + FLEET_POLL_SLACK_S):
        raise AssertionError(f"{label}: kill drill {kill}")
    stats = {**report, "max_err": max(errs),
             "seconds": time.perf_counter() - t0}
    log(f"{label}: {json.dumps(stats)}")
    log(f"{label}: after the SIGKILL, death detected in "
        f"{kill['detected_after_kill_s']:.3f} s, tenants reassigned in "
        f"{kill['reassigned_after_kill_s']:.3f} s, converged in "
        f"{kill['converged_after_kill_s']:.3f} s, replacement in "
        f"{kill['replacement_joined_s']:.3f} s")
    return stats


def lag_windows(points, ws: float, lo: float, hi: float, w: int):
    """A tenant's store window as the planner should hold it, from the
    (t, value) points this process appended to the history and nothing
    the planner computed: the in-window mean of every aggregation window
    with a point and a start in [lo, hi], the last `w` of them, oldest
    first and left-padded invalid ([w] float32, [w] valid, [w] starts)."""
    sums: dict = {}
    for t, v in points:
        start = math.floor(t / ws) * ws
        if lo <= start <= hi:
            acc = sums.setdefault(start, [0.0, 0])
            acc[0] += v
            acc[1] += 1
    starts = sorted(sums)[-w:]
    x = np.zeros(w, np.float32)
    valid = np.zeros(w, bool)
    ts = np.zeros(w, np.float64)
    k = len(starts)
    if k:
        x[w - k:] = [sums[t][0] / sums[t][1] for t in starts]
        valid[w - k:] = True
        ts[w - k:] = starts
    return x, valid, ts


async def phase_fleet_forecast(torch) -> dict:
    """The controller's predictive planner (`fleet/forecast.py`) on the
    card, as the JAX package's forecast smoke drives it: synthetic ramp
    history in the controller runtime's telemetry tier, `seasonal`
    trained from it and checkpointed, tenant-0 served through the pool
    on the card until both tenants have a forecast; the controller's
    `autoscale()` then records one `add_replica` whose reason is the
    forecast, with its provenance. The slot's store windows must equal
    the windows built here from the lag points this phase appended (their
    in-window means), and the forecasts are held against the CPU model on
    the checkpoint's weights over those windows."""
    import tempfile as tf

    from sitewhere_tpu_torch.config import (
        RESERVED_TENANT,
        InstanceSettings,
        TenantConfig,
    )
    from sitewhere_tpu_torch.convert import params_from_numpy
    from sitewhere_tpu_torch.fleet import AutoscalerPolicy, FleetController
    from sitewhere_tpu_torch.kernel.service import ServiceRuntime
    from sitewhere_tpu_torch.models import build_model

    label = "fleet-forecast"
    t0 = time.perf_counter()
    ws = 1.0
    tenants = ("acme", "beta")
    with tf.TemporaryDirectory(prefix="smoke-forecast-",
                               dir=scratch_dir()) as d:
        rt = ServiceRuntime(InstanceSettings(
            instance_id="forecast", data_dir=d, observe_history_window_s=ws,
            fleet_forecast_window=16, fleet_forecast_horizon_s=4.0,
            fleet_forecast_interval_s=0.0, fleet_forecast_min_windows=6))
        await rt.start()
        try:
            controller = FleetController(rt, policy=AutoscalerPolicy(
                scale_up_lag=300.0, cooldown_s=0.0))
            for tid in tenants:
                controller.add_tenant(TenantConfig(tenant_id=tid))
            controller.handle_control({"kind": "heartbeat", "worker": "w1",
                                       "seq": 1, "epoch": 0,
                                       "owned": list(tenants),
                                       "ready": True})
            h = rt.history
            points = {tid: [] for tid in tenants}

            def append(tid, value, t):
                h.append(tid, "lag", value, t=t)
                points[tid].append((t, value))

            base = math.floor(time.time() / ws) * ws - 60 * ws
            for i in range(58):  # a clean per-tenant load ramp
                for tid in tenants:
                    append(tid, 40.0 * i, base + i * ws + 0.5)
            h.flush()
            controller._ensure_planner()
            planner = controller.planner
            t_train = time.perf_counter()
            report = planner.train_from_history()
            train_s = time.perf_counter() - t_train
            if report is None or report["version"] != 1:
                raise AssertionError(f"{label}: train report {report}")
            # tenant-0 serving starts and backfills the windows closed
            # before this tick's open one
            first_tick = [time.time()]
            await planner.tick()
            first_tick.append(time.time())
            t_serve = time.perf_counter()
            deadline = time.monotonic() + 60.0
            decision = None
            while decision is None:
                if time.monotonic() > deadline:
                    raise AssertionError(f"{label}: no decision in 60 s: "
                                         f"{planner.snapshot()}")
                # the ramp goes on: newly closed windows keep arriving
                wall = time.time()
                for tid in tenants:
                    append(tid, 40.0 * (wall - base) / ws, wall)
                last_tick = [time.time()]
                await planner.tick()
                last_tick.append(time.time())
                await asyncio.sleep(0.1)
                if set(planner.forecasts) == set(tenants):
                    decision = controller.autoscale()
            decide_s = time.perf_counter() - t_serve
            if not decision["reason"].startswith("forecast:") \
                    or "forecast" not in decision:
                raise AssertionError(f"{label}: decision {decision}, "
                                     f"{planner.snapshot()}")
            await planner.slot.drain(timeout=10.0)
            if controller.decisions[-1] is not decision:
                raise AssertionError(f"{label}: the decision is not in the "
                                     "controller's audit trail")
            weights, meta = planner._checkpoint_store().load(
                RESERVED_TENANT, planner.model.name)
            cpu_model = build_model(
                "seasonal", device="cpu", window=planner.window,
                horizon=planner.horizon_steps)
            devices = np.array([planner._devmap[t] for t in tenants])
            w = planner.window
            x, valid = planner.store.window(devices, w)
            ts = planner.store.channel(0).window_ts(devices, w)
            # the backfill read the `w` windows before the first tick's
            # open one, each later tick the windows closed since: either
            # bound may sit one window later where a tick crossed a
            # window's edge
            los = {math.floor(t / ws) * ws - w * ws for t in first_tick}
            his = {math.floor(t / ws) * ws - ws for t in last_tick}
            x_ref = np.zeros_like(x)
            valid_ref = np.zeros_like(valid)
            for i, tid in enumerate(tenants):
                for lo, hi in ((lo, hi) for lo in los for hi in his):
                    xr, vr, tr = lag_windows(points[tid], ws, lo, hi, w)
                    if np.array_equal(vr, valid[i]) \
                            and np.array_equal(tr[vr], ts[i][valid[i]]) \
                            and np.allclose(xr[vr], x[i][valid[i]],
                                            rtol=1e-6, atol=0.0):
                        x_ref[i], valid_ref[i] = xr, vr
                        break
                else:
                    raise AssertionError(
                        f"{label} {tid}: the store's window (starts "
                        f"{ts[i][valid[i]].tolist()}, values "
                        f"{x[i][valid[i]].tolist()}) is not the lag "
                        f"appended here")
            ref = cpu_model.score(params_from_numpy(weights, "cpu"),
                                  torch.from_numpy(x_ref),
                                  torch.from_numpy(valid_ref)).numpy()
            got = np.array([planner.forecasts[t]["load"] for t in tenants],
                           np.float32)
            err = check_close(label, got, ref)
            snap = planner.snapshot()
            device = str(planner.pool.device)
        finally:
            if controller.planner is not None:
                controller.planner.close()
            await rt.stop()
    stats = {"train": {k: report[k] for k in ("version", "windows",
                                              "final_loss", "steps")},
             "train_s": train_s, "decision_after_serving_s": decide_s,
             "decision": decision, "device": device,
             "forecasts": snap["forecasts"], "gate": snap["gate"],
             "checkpoint_version": meta["version"], "max_err": err,
             "seconds": time.perf_counter() - t0}
    log(f"{label}: {json.dumps(stats)}")
    if not device.startswith("cuda"):
        raise AssertionError(f"{label}: tenant-0 served on {device}")
    return stats


async def phase_cli_fleet() -> dict:
    """The fleet through the CLI: `run --fleet-controller --serve-bus-port
    0` hosting instance-management and event-sources (the default tenant,
    a TCP gateway, REST); SIMULATE_DEVICES devices registered onto the
    broker's bus by a seeding runtime here (registry replication: the
    workers adopt by bus replay); two `fleet-worker` processes on the
    card; `fleet status` until both heartbeat and the tenant is adopted;
    `cli simulate` for 2 s; SIGKILL of the tenant's owner; `fleet status`
    until the survivor owns it; `cli simulate` for 2 s again. Every event
    sent is persisted: the event-management group commits through the
    end of the tenant's inbound topic, and the persisted topic it
    republishes to holds every (device, time) sent. SIGTERM stops the
    survivor and the controller with exit 0."""
    import socket

    from sitewhere_tpu_torch.config import InstanceSettings, TenantConfig
    from sitewhere_tpu_torch.domain.model import DeviceType
    from sitewhere_tpu_torch.kernel.bus import TopicNaming
    from sitewhere_tpu_torch.kernel.service import ServiceRuntime
    from sitewhere_tpu_torch.kernel.wire import RemoteEventBus
    from sitewhere_tpu_torch.services import DeviceManagementService

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        gateway = sock.getsockname()[1]
    t0 = time.monotonic()
    steps = {}
    mark = lambda step: steps.__setitem__(  # noqa: E731
        step, time.monotonic() - t0)

    async def status(port: str) -> dict:
        proc = await cli_exec("fleet", "status", "--json", "--port", port)
        out, err = await asyncio.wait_for(proc.communicate(), 60.0)
        if proc.returncode != 0:
            raise AssertionError(f"cli fleet status: exit {proc.returncode}"
                                 f" {err.decode()[-2000:]}")
        return json.loads(out)

    async def settled(port: str, workers: set, timeout: float) -> dict:
        deadline = time.monotonic() + timeout
        while True:
            report = await status(port)
            rows = report["workers"]
            if report["converged"] and set(rows) == workers \
                    and report["owners"].get("default") and all(
                        sorted(r["owned"]) == sorted(
                            t for t, w in report["assignment"].items()
                            if w == wid) for wid, r in rows.items()):
                return report
            for p in procs[1:]:
                if p.proc.returncode is not None and p not in killed:
                    raise AssertionError(f"cli fleet: {p.args[:3]} exited "
                                         f"{p.proc.returncode}: {p.tail()}")
            if time.monotonic() > deadline:
                raise AssertionError(f"cli fleet: not settled on {workers} "
                                     f"in {timeout} s: {report}")
            await asyncio.sleep(0.25)

    ctl = await CliProcess(
        "run", "--fleet-controller", "--serve-bus-port", "0", "--services",
        "instance-management,event-sources", "--port", "0",
        "--gateway-port", str(gateway)).start()
    procs, killed, remote, reader = [ctl], [], None, None
    sent = []
    try:
        m = await ctl.expect(r"bus served to wire peers on ([\d.]+):(\d+)",
                             120.0)
        host, bus_port = m.group(1), int(m.group(2))
        rest = (await ctl.expect(r"up; REST on [\d.]+:(\d+)", 120.0)).group(1)
        mark("controller")
        # the registry onto the broker's bus before any worker adopts
        # (fleet-managed: the instance's tenant broadcasts spin nothing
        # here, only the explicit adopt does)
        seed = ServiceRuntime(InstanceSettings(registry_replication=True,
                                               fleet_managed=True),
                              bus=RemoteEventBus(host, bus_port))
        seed.add_service(DeviceManagementService(seed))
        await seed.start()
        await seed.adopt_tenant(TenantConfig(tenant_id="default"))
        seed.api("device-management").management("default").bootstrap_fleet(
            DeviceType(token="thermo", name="Thermometer"), SIMULATE_DEVICES)
        await seed.stop()
        mark("registry")
        remote = RemoteEventBus(host, bus_port)
        await remote.initialize()
        naming = TopicNaming(InstanceSettings().instance_id)
        persisted_topic = naming.tenant_topic(
            "default", TopicNaming.OUTBOUND_ENRICHED)
        reader = remote.subscribe(persisted_topic, group="smoke-persisted")
        await reader.poll(max_records=1, timeout=0.05)  # joins the group
        for wid in ("w0", "w1"):
            procs.append(await CliProcess(
                "fleet-worker", "--bus", f"{host}:{bus_port}",
                "--worker-id", wid).start())
        first = await settled(rest, {"w0", "w1"}, 300.0)
        mark("workers")
        sent.append((await run_simulate("tcp", gateway))[0])
        mark("simulate")
        owner = first["owners"]["default"]
        victim = procs[1 + ["w0", "w1"].index(owner)]
        victim.proc.kill()
        await victim.proc.wait()
        killed.append(victim)
        survivor = ({"w0", "w1"} - {owner}).pop()
        moved = await settled(rest, {survivor}, 120.0)
        mark("moved")
        sent.append((await run_simulate("tcp", gateway))[0])
        mark("simulate-after")
        keys = set()
        deadline = time.monotonic() + 120.0
        while True:
            for rec in await reader.poll(max_records=256, timeout=0.2):
                batch = rec.value  # persisted batches; alerts ride as lists
                if hasattr(batch, "device_index"):
                    keys.update(zip(batch.device_index.tolist(),
                                    batch.ts.tolist()))
            all_lags = await remote.group_lags()
            lags = all_lags.get("default.event-management", {})
            # group_lags lists a topic only while the group lags on it
            if len(keys) >= sum(sent) and "default.event-management" \
                    in all_lags and not any(lags.values()):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"cli fleet: {len(keys)} of {sum(sent)}"
                                     f" events persisted, event-management "
                                     f"lags {all_lags}")
        mark("persisted")
    finally:
        if reader is not None:
            reader.close()
        if remote is not None:
            await remote.stop()
        live = [p for p in procs[1:] if p not in killed]
        rcs = dict(zip([p.args[4] for p in live],
                       await asyncio.gather(*(p.stop() for p in live))))
        rcs["run"] = await ctl.stop()
    mark("stopped")
    stats = {"sent": sent, "persisted": len(keys), "killed": owner,
             "epochs": [first["epoch"], moved["epoch"]], "exit": rcs,
             "steps_s": steps, "seconds": time.monotonic() - t0}
    log(f"cli-fleet: {json.dumps(stats)}")
    if not all(sent) or len(keys) != sum(sent):
        raise AssertionError(f"cli fleet: {stats}")
    return stats

# -- the bench entry: every mode on the card --------------------------------

def bench_run(name: str, argv, timeout: float) -> dict:
    """One `python -m <argv>` in a fresh interpreter: its stdout, stderr
    and seconds; a non-zero exit raises with the output's tail."""
    t0 = time.perf_counter()
    try:
        out = subprocess.run([sys.executable, "-m", *argv], cwd=os.path.dirname(
            os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=timeout)
    except subprocess.TimeoutExpired as exc:
        raise AssertionError(f"bench-{name}: not done in {timeout} s; its "
                             f"stderr ends: {(exc.stderr or b'')[-3000:]!r}")
    if out.returncode != 0:
        raise AssertionError(f"bench-{name}: exit {out.returncode}; stdout "
                             f"ends {out.stdout[-1500:]!r}; stderr ends "
                             f"{out.stderr[-3000:]}")
    return {"stdout": out.stdout, "stderr": out.stderr,
            "seconds": time.perf_counter() - t0}


def bench_report(name: str, run: dict) -> dict:
    """A `cli bench` run's report (its last stdout line, which must hold
    no `error`) and its K1 record (the stderr's `[bench] kernels` line)."""
    report = json.loads(run["stdout"].strip().splitlines()[-1])
    if "error" in report:
        raise AssertionError(f"bench-{name}: {report['error']}; stderr ends "
                             f"{run['stderr'][-3000:]}")
    k1 = [json.loads(ln[len("[bench] kernels "):])["lstm_window_final"]
          for ln in run["stderr"].splitlines()
          if ln.startswith("[bench] kernels ")]
    return {**run, "report": report, "k1": k1[-1] if k1 else None}


def check_bench(name: str, run: dict, kind: str) -> dict:
    """The checks of one bench run (see `phase_bench`); returns its stats
    line."""
    r, k1 = run["report"], run["k1"]

    def need(ok, what):
        if not ok:
            raise AssertionError(f"bench-{name}: {what}: "
                                 f"{json.dumps(r)[:4000]}")

    need(r.get("platform") == "gpu" and r.get("device_kind") == kind,
         f"platform / device_kind not gpu / {kind}")
    stats = {"seconds": run["seconds"], "metric": r["metric"],
             "value": r["value"]}
    if name in ("default", "window", "chaos", "mesh"):
        need(r["value"] > 0 and all(v for k, v in r["drain"].items()
                                    if k.endswith("complete")),
             "no events/s or a drain incomplete")
        need(r["model_flops_per_event"] > 0 and r["mfu"] is not None
             and 0 < r["mfu"] <= 1, "mfu outside (0, 1]")
        stats.update({k: r[k] for k in ("value_median", "p50_ms", "p99_ms",
                                        "p99_breakdown", "mfu", "pallas")})
        stats["dispatches"] = r["scoring"]["dispatches"]
        stats["k1"] = k1
    if name == "window":
        need(r["pallas"] == "cuda", "pallas is not cuda")
        need(k1 is not None and k1["launches"] == k1["dispatches"] > 0,
             f"K1 launches {k1} != dispatches")
    if name == "replay":
        need(r["value"] > 0 and r["events"] == 500_000 and all(
            t["events"] == r["events"] for t in r["trials"]),
             "a pass did not score the whole corpus")
        stats.update({k: r[k] for k in ("value_median", "events", "trials",
                                        "warmup_s", "corpus_build_s")})
    if name == "workers":
        f = r["fleet"]
        z = f["zombie"]
        need(r["value"] > 0 and all(t["drain_complete"]
                                    for t in r["saturation_trials"]),
             "no events/s or a drain incomplete")
        need(z["lost_accepted_events"] == 0
             and z["duplicate_committed_events"] == 0
             and z["fenced_rejections"] >= 1 and z["sigcont_mid_reassignment"]
             and z["drain_complete"] and z["post_reconverge_drain_complete"],
             "the zombie drill")
        stats.update({"value_median": r["value_median"], "zombie": z,
                      "converge_s": f["converge_s"],
                      "epoch": f["epoch"]})
    if name == "overload":
        good = list(r["goodput_ratios"])
        need(r["shed_events"]["hog"] > 0
             and r["accepted"]["hog"] < r["offered"]["hog"],
             "the hog was not shed")
        need(all(r["shed_events"][t] == 0
                 and r["accepted"][t] == r["offered"][t] for t in good)
             and r["value"] >= OVERLOAD_RETENTION,
             f"a well-behaved tenant lost goodput (< {OVERLOAD_RETENTION})")
        stats.update({k: r[k] for k in (
            "hog_vs_quota", "goodput_ratios", "shed_events",
            "baseline_latency", "contended_latency")})
    if name == "chaos":
        c = r["chaos"]
        need(sum(site.get("injected", 0) for site in c["sites"].values()) > 0,
             "no fault injected")
        stats["chaos"] = c
    if name == "ramp":
        ramp = r["ramp"]
        need(ramp["ramp_drain_complete"], "the ramp's drain incomplete")
        need(ramp["kill"] is not None
             and ramp["kill"]["lost_accepted_events"] == 0
             and ramp["kill"]["drain_complete"], "the ramp's kill drill")
        stats.update({k: ramp[k] for k in (
            "saturation_rate", "scale_up_lag_armed", "backlog_peak_events",
            "ramp_drain_s", "good_paced_p50_ms", "good_paced_p99_ms",
            "workers_final", "converge_s", "train",
            "forecast_attributed_decisions", "kill")})
    if name == "mesh":
        # the reference's fit: every card, D×M wanted; on one card the
        # degrade to meshless, logged
        from sitewhere_tpu_torch.parallel.mesh import (
            mesh_devices,
            mesh_from_spec,
        )

        spec = {"data": 4, "model": 2}
        fit = mesh_from_spec(spec, mesh_devices())
        want = {"spec": spec, "shape": dict(fit.shape) if fit else None,
                "devices": fit.size if fit else 0}
        need(r["scoring"]["mesh"] == want, f"scoring.mesh is not {want}")
        said = ("running meshless" if fit is None else "fitting")
        need(said in run["stderr"], f"no `{said}` warning")
        stats["scoring_mesh"] = r["scoring"]["mesh"]
        stats["warning"] = next(ln for ln in run["stderr"].splitlines()
                                if said in ln)
    log(f"bench-{name}: {json.dumps(stats)}")
    return stats


def logical_cards(torch, n: int) -> list:
    """`n` mesh positions over the cards: distinct cards while there are
    enough, then cuda:0, cuda:1, … again (logical devices)."""
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def phase_lint() -> dict:
    """The port's swxlint over the port (host only)."""
    from sitewhere_tpu_torch.analysis import lint_package

    t0 = time.perf_counter()
    report = lint_package()
    by_code: dict = {}
    for f in report.findings:
        by_code.setdefault(f.code, {"new": 0, "baselined": 0})["new"] += 1
    for f, _ in report.baselined:
        by_code.setdefault(f.code, {"new": 0, "baselined": 0})[
            "baselined"] += 1
    stats = {"seconds": time.perf_counter() - t0,
             "files": report.checked_files, "new": len(report.findings),
             "baselined": len(report.baselined),
             "suppressed": len(report.suppressed), "by_code": by_code,
             "timings_s": {c: round(t, 4)
                           for c, t in sorted(report.timings.items())}}
    log(f"lint: {json.dumps(stats)}")
    if report.findings or report.stale_baseline \
            or report.undocumented_baseline:
        raise AssertionError(f"lint: {report.render_text()}")
    return stats


async def phase_mesh_pool(torch) -> dict:
    """The pool at the bench's megabatch shape over a {data: 2, model: 2}
    mesh, then meshless, on the same tenants, weights and ticks."""
    from sitewhere_tpu_torch.parallel.mesh import make_mesh
    from sitewhere_tpu_torch.tools import main_path

    tenants, devices, buckets = MESH_POOL
    mesh = make_mesh(MESH_SPEC["data"], MESH_SPEC["model"],
                     devices=logical_cards(torch, 4))
    runs = {}
    for label, m in (("mesh", mesh), ("meshless", None)):
        t0 = time.perf_counter()
        path = await main_path.build_pool("t", "lstm-stream", tenants,
                                          devices, buckets, mesh=m)
        setup_s = time.perf_counter() - t0
        flush_ms, scores, n_events = [], [], 0
        t_wall = time.perf_counter()
        for k in range(MESH_TICKS):
            t = path.t + TICK_S * k
            ticks = {tid: mm.sim.tick(t=t)[0]
                     for tid, mm in path.tenants.items()}
            for tid, batch in ticks.items():
                path.ingest(tid, batch)
            t1 = time.perf_counter()
            scored = await path.flush()
            flush_ms.append(1e3 * (time.perf_counter() - t1))
            for tid, batch in ticks.items():
                check_scored(f"mesh-pool {label} {tid}", scored[tid],
                             batch.device_index)
                n_events += batch.device_index.shape[0]
            scores.append({tid: scored[tid].score for tid in ticks})
        wall = time.perf_counter() - t_wall
        mstats = path.pool.mesh_stats()
        runs[label] = {
            "setup_s": setup_s, "wall_s": wall, "events": n_events,
            "events_per_s": n_events / wall,
            "flush_p50_ms": float(np.quantile(flush_ms, 0.5)),
            "flush_p99_ms": float(np.quantile(flush_ms, 0.99)),
            "mesh_devices": mstats["devices"], "shape": mstats["shape"],
            "devices": sorted({str(d) for d in m.devices.flat})
            if m is not None else None}, scores
        path.pool.close()
        torch.cuda.empty_cache()
    err = max(check_close(f"mesh-pool tick {k} {tid}", on[tid], off[tid])
              for k, (on, off) in enumerate(zip(runs["mesh"][1],
                                                runs["meshless"][1]))
              for tid in on)
    stats = {label: run[0] for label, run in runs.items()}
    stats["max_abs_err_vs_meshless"] = err
    log(f"mesh-pool: {json.dumps(stats)}")
    if stats["mesh"]["mesh_devices"] != 4 \
            or stats["mesh"]["shape"] != MESH_SPEC \
            or stats["meshless"]["mesh_devices"] != 0:
        raise AssertionError(f"mesh-pool: mesh_stats {stats}")
    return stats


def phase_ring(torch) -> dict:
    """Ring attention over a 4-way `seq` axis against dense attention,
    then longwin sequence-parallel against meshless, at longwin-512's
    width."""
    from sitewhere_tpu_torch.models.longwin import (
        LongWindowConfig,
        LongWindowModel,
    )
    from sitewhere_tpu_torch.parallel.mesh import Mesh, make_mesh
    from sitewhere_tpu_torch.parallel.ring import (
        dense_attention,
        ring_attention_sharded,
    )

    dev = torch.device("cuda", 0)
    cards = logical_cards(torch, RING_AXIS)
    seq = Mesh(np.array(cards, dtype=object), ("seq",))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shape = (RING_B, RING_W, RING_HEADS, RING_D // RING_HEADS)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               for _ in range(3))
    valid = torch.rand((RING_B, RING_W), generator=gen, device=dev) > 0.1
    stats: dict = {"devices": sorted({str(c) for c in cards})}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
        # one untimed call of each first (allocator growth, first launches)
        ring_attention_sharded(qd, kd, vd, valid, seq, "seq", causal=True)
        dense_attention(qd, kd, vd, valid, causal=True)
        ring, ring_ms = timed(lambda: ring_attention_sharded(
            qd, kd, vd, valid, seq, "seq", causal=True))
        dense, dense_ms = timed(lambda: dense_attention(
            qd, kd, vd, valid, causal=True))
        err = float((ring - dense).abs().max())
        stats[f"ring_{name}"] = {"max_abs_err": err, "ring_ms": ring_ms,
                                 "dense_ms": dense_ms}
        del ring, dense
        torch.cuda.empty_cache()
        if not err <= RING_ATOL[name]:
            raise AssertionError(f"ring: {name} ring vs dense {err}")
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.normal(20.0, 2.0, (LONGWIN_ROWS, RING_W))
                         .astype(np.float32)).to(dev)
    ok = torch.ones_like(x, dtype=torch.bool)
    mesh = make_mesh(RING_AXIS, 1, devices=cards)
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        cfg = LongWindowConfig(window=RING_W, compute_dtype=dt)
        plain = LongWindowModel(cfg)
        sp = LongWindowModel(cfg, mesh=mesh)
        params = plain.init(torch.Generator().manual_seed(SEED))
        with torch.no_grad():
            xn, _, _ = plain._normalize(x, ok.float())
            plain._quantile_deltas(params, xn, ok.float())
            sp._quantile_deltas(params, xn, ok.float())
            want, plain_ms = timed(lambda: plain._quantile_deltas(
                params, xn, ok.float()))
            got, sp_ms = timed(lambda: sp._quantile_deltas(
                params, xn, ok.float()))
            loss_plain = float(plain.loss(params, x, ok))
            loss_sp = float(sp.loss(params, x, ok))
        err = (got - want).abs()
        within = float((err <= LW_BF16_ATOL).float().mean())
        rel = abs(loss_sp - loss_plain) / abs(loss_plain)
        stats[f"longwin_{name}"] = {
            "max_abs_err": float(err.max()), "share_within_1e-2": within,
            "loss": loss_sp, "loss_meshless": loss_plain, "loss_rel": rel,
            "sequence_parallel_ms": sp_ms, "meshless_ms": plain_ms}
        del got, want, err
        torch.cuda.empty_cache()
        if name == "float32":
            bad = (stats["longwin_float32"]["max_abs_err"] > LW_F32_ATOL
                   or rel > LW_F32_LOSS_RTOL)
        else:
            bad = within < LW_BF16_SHARE or rel > LW_BF16_LOSS_RTOL
        if bad:
            raise AssertionError(f"ring: longwin {name} {stats}")
    log(f"ring: {json.dumps(stats)}")
    return stats


def phase_train_dp(torch) -> dict:
    """`Trainer` data-parallel over `data: 2` against meshless on the same
    batches, then `cli train --distributed` as one nccl process."""
    import socket

    from sitewhere_tpu_torch.models import build_model
    from sitewhere_tpu_torch.parallel.mesh import make_mesh
    from sitewhere_tpu_torch.training.trainer import (
        Trainer,
        TrainerConfig,
        make_windows,
    )

    model = build_model("lstm", window=WINDOW)
    rng = np.random.default_rng(SEED)
    values = rng.normal(20.0, 2.0, (1024, 192)).astype(np.float32)
    windows, valid = make_windows(values, np.full(1024, 192), window=WINDOW,
                                  max_windows=500_000)
    cfg = TrainerConfig(batch_size=DP_BATCH, steps=DP_STEPS, seed=SEED,
                        log_every=1)
    params = model.init(torch.Generator().manual_seed(SEED))
    mesh = make_mesh(DP_DATA, 1, devices=logical_cards(torch, DP_DATA))
    _, dp = Trainer(model, cfg, mesh=mesh).train(windows, valid,
                                                 params=params)
    _, plain = Trainer(model, cfg).train(windows, valid, params=params)
    rel = max(abs(a - b) / abs(b) for a, b in zip(dp["losses"],
                                                   plain["losses"]))
    stats = {"data": DP_DATA,
             "devices": sorted({str(d) for d in mesh.devices.flat}),
             "losses": dp["losses"], "losses_meshless": plain["losses"],
             "max_rel": rel, "seconds": dp["seconds"],
             "seconds_meshless": plain["seconds"]}
    if rel > DP_RTOL:
        raise AssertionError(f"train-dp: {json.dumps(stats)}")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, SWX_COORDINATOR=f"127.0.0.1:{port}",
               SWX_NUM_PROCESSES="1", SWX_PROCESS_ID="0")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "sitewhere_tpu_torch.cli", "train",
         "--distributed", "--model", "lstm", "--steps", str(DP_STEPS),
         "--batch-size", str(DP_BATCH)],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=300)
    lines = out.stdout.strip().splitlines()
    report = json.loads(lines[-1]) if lines else {}
    stats["cli_distributed"] = {"exit": out.returncode, "rank": lines[0]
                                if lines else None, **report,
                                "command_seconds": time.perf_counter() - t0}
    log(f"train-dp: {json.dumps(stats)}")
    log("train-dp: two ranks cannot share one card under nccl; the "
        "two-process lockstep is a CPU test on gloo "
        "(tests/test_torch_distributed.py)")
    if (out.returncode != 0 or not lines
            or lines[0] != "train: rank 0/1 backend=nccl data=1"
            or not np.isfinite(report.get("final_loss", float("nan")))):
        raise AssertionError(f"train-dp: cli train --distributed exit "
                             f"{out.returncode}: {out.stdout[-2000:]} "
                             f"{out.stderr[-3000:]}")
    return stats


def phase_bench(kind: str) -> dict:
    """`cli bench` (`tools/bench.py`) in fresh interpreters on the card, at
    the bench's full width with short windows (BENCH_RUNS, lanes side by
    side). Each run: the last line parses with no `error`, `platform` gpu
    and `device_kind` the card's name, and its own checks: the default
    (`lstm-stream` in the pool), `window` (`--model lstm --no-megabatch`:
    `pallas` cuda and K1's launches == dispatches over the measured phases)
    and `chaos` (faults injected) with events/s > 0, every drain complete
    and 0 < mfu ≤ 1; `replay` scoring the whole 500,000-event corpus each
    pass; `workers` (`--workers 2 --zombie-drill --no-fleet-kill`) losing
    no accepted event in the zombie drill, the zombie's writes fenced and
    nothing committed twice after; `overload` shedding the hog while
    the well-behaved tenants keep their goodput; `ramp` drained, with its
    kill drill losing nothing. Then `tools/ab_compare.py fastlane`: both
    legs' reports under build/bench and the table."""
    import concurrent.futures

    def lane(names):
        out = {}
        for name in names:
            flags, timeout = BENCH_RUNS[name]
            out[name] = bench_report(name, bench_run(
                name, ("sitewhere_tpu_torch.cli", "bench", *flags), timeout))
        return out

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(BENCH_LANES)) as pool:
        runs = {}
        for part in pool.map(lane, BENCH_LANES):
            runs.update(part)
    stats = {name: check_bench(name, runs[name], kind)
             for lanes in BENCH_LANES for name in lanes}
    prefix = os.path.join(scratch_dir(), "bench", "fastlane")
    ab = bench_run("ab-fastlane", ("sitewhere_tpu_torch.tools.ab_compare",
                                   BENCH_AB[0], "--prefix", prefix, "--",
                                   *BENCH_AB[1:]), 480)
    legs = {}
    for tag in ("off", "on"):
        with open(f"{prefix}_{tag}.json") as f:
            leg = json.load(f)
        if leg.get("fastlane") != tag or not all(
                v for k, v in leg["drain"].items() if k.endswith("complete")):
            raise AssertionError(f"bench-ab-fastlane: the {tag} leg "
                                 f"{json.dumps(leg)[:3000]}")
        legs[tag] = {k: leg[k] for k in ("value", "value_median", "p50_ms",
                                          "p99_ms", "pipeline_owned_p99_ms")}
    log(f"bench-ab-fastlane: {json.dumps({'seconds': ab['seconds'], **legs})}")
    log(ab["stdout"].strip())
    stats["ab-fastlane"] = legs
    log(f"bench: {time.perf_counter() - t0:.1f} s")
    return stats


def main() -> int:
    import torch

    t_start = time.perf_counter()
    last = [t_start]

    def mark(label: str) -> None:
        """One line of the script's time budget: the phases since the last
        mark, and the total so far."""
        now = time.perf_counter()
        log(f"time: {label} {now - last[0]:.1f} s (total "
            f"{now - t_start:.1f} s)")
        last[0] = now

    kind = phase_device(torch)
    phase_build()
    rows, widths = phase_kernels(torch)
    stream_rows = phase_stream_kernel(torch)
    tft_fused = phase_tft_fused(torch)
    mark("device, build, kernels")
    stats = asyncio.run(phase_main(torch))
    asyncio.run(phase_stream(torch))
    pools = [asyncio.run(drive_pool(torch, f"pool-{tenants}x{devices}",
                                    "lstm-stream", tenants, devices, buckets,
                                    fleet_ticks=4))
             for tenants, devices, buckets in POOLS]
    tenants, devices, buckets = WINDOW_POOL
    asyncio.run(drive_pool(torch, f"pool-window-{tenants}x{devices}", "lstm",
                           tenants, devices, buckets, fleet_ticks=1))
    mark("main, stream, pools")
    asyncio.run(phase_pipeline(torch, "pipeline-stream", "lstm-stream",
                               megabatch=True))
    asyncio.run(phase_pipeline(torch, "pipeline-window", "lstm",
                               megabatch=False))
    phase_demo()
    phase_native()
    mark("pipelines, demo, native")
    pool_tft = asyncio.run(drive_pool(torch, f"pool-tft-1x{FLEET}", "tft", 1,
                                      FLEET, (FLEET,), fleet_ticks=1))
    # untrained longwin scores ordinary points at the clip: no anomaly
    # bar; its bf16 sample is held in aggregate, its float32 run row for row
    for dtype, suffix in ((None, ""), (torch.float32, "-float32")):
        asyncio.run(drive_pool(torch, f"pool-longwin-1x{FLEET}{suffix}",
                               "longwin", 1, FLEET, (FLEET,), fleet_ticks=1,
                               anomalies=False, dtype=dtype))
        asyncio.run(phase_longwin_512(torch, dtype))
    tenants, devices, buckets = SEASONAL_POOL
    asyncio.run(drive_pool(torch, f"seasonal-{tenants}x{devices}", "seasonal",
                           tenants, devices, buckets, fleet_ticks=1,
                           anomalies=False))
    asyncio.run(phase_forecast(torch))
    phase_maintenance(torch)
    mark("other models, forecast, maintenance")
    with tempfile.TemporaryDirectory(prefix="smoke-durable-",
                                     dir=scratch_dir()) as data_dir:
        logged = asyncio.run(phase_durable(torch, data_dir))
        asyncio.run(phase_replay(torch))
        phase_cli_replay(data_dir, logged)
        ckpt = os.path.join(data_dir, "checkpoints")
        phase_train(ckpt)
        phase_replay_candidate(data_dir, ckpt)
    mark("durable, replay, train")
    asyncio.run(phase_ingress(torch))
    asyncio.run(phase_ingress_window(torch))
    asyncio.run(phase_platform(torch))
    mark("ingress, platform")
    for label, model in (("split-window", "lstm"),
                         ("split-stream", "lstm-stream")):
        asyncio.run(phase_split(torch, label, model))
    asyncio.run(phase_cli_split())
    mark("split, cli-split")
    asyncio.run(phase_fleet_window(torch))
    asyncio.run(phase_fleet_forecast(torch))
    asyncio.run(phase_cli_fleet())
    mark("fleet, fleet-forecast, cli-fleet")
    phase_lint()
    asyncio.run(phase_mesh_pool(torch))
    phase_ring(torch)
    phase_train_dp(torch)
    mark("lint, mesh-pool, ring, train-dp")
    phase_bench(kind)
    mark("bench")
    top = rows[-1]  # the main path's full flushes run at the largest bucket
    kernels = [{
        "name": "lstm_window_final",
        "route": "cuda",
        "source": "sitewhere_tpu_torch/csrc/lstm_window.cu",
        "replaces": "sitewhere_tpu/ops/lstm_kernel.py:75",
        "launches": stats["kernel_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows + widths),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "shape": {"batch": top["batch"], "steps": WINDOW - 1,
                  "hidden": HIDDEN},
        "per_bucket": rows,
        "widths": widths,
    }]
    # K2 at the main path's shape: one tenant, the largest bucket
    top = next(r for r in stream_rows
               if r["tenants"] == 1 and r["batch"] == BUCKETS[-1]
               and r["scores"] == "float16")
    kernels.append({
        "name": "lstm_stream_step",
        "route": "cuda",
        "source": "sitewhere_tpu_torch/csrc/lstm_stream_step.cu",
        "replaces": None,
        "launches": pools[0]["stream_kernel_launches"],
        "max_score_err": max(r["max_score_err"] for r in stream_rows),
        "ms": top["ms"], "graph_ms": top["graph_ms"],
        "plain_ms": top["plain_ms"], "host_ms": top["host_ms"],
        "plain_host_ms": top["plain_host_ms"], "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "shape": {"tenants": 1, "batch": top["batch"], "hidden": HIDDEN},
        "per_bucket": stream_rows,
    })
    # K3 at the main path's shape: the electricity widths, 16,384 rows
    kernels.append({
        "name": "tft_fused",
        "route": "cuda",
        "source": "sitewhere_tpu_torch/csrc/tft_fused.cu",
        "replaces": None,
        # the main path's own run: the pool's `tft` at TftConfig's defaults
        "launches": pool_tft["tft_fused_launches"],
        "launches_per_forward": pool_tft["tft_fused_launches_per_forward"],
        "product_launches": pool_tft["tft_fused_product_launches"],
        "products_per_forward": pool_tft["tft_fused_products_per_forward"],
        "per_kernel": tft_fused["kernels"],
        "per_bucket": tft_fused["buckets"],
    })
    # again at the end, beside the records (a long log's head may be cut)
    log(card_line())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
