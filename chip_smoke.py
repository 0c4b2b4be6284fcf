"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each of which fails the run on error (nothing is caught):

1. Build every CUDA kernel of ``pmp_vvc_tpu_torch/csrc`` with nvcc (sm_90a).
2. Hold the structural-vote kernel (K8) against its plain PyTorch version on
   the card, exactly, on 65,536 seeded maps that include rounding ties and
   every zero-count band; time both at the prediction path's batch (512)
   and at 65,536.
3. The main path: ``predict_sequence`` on a 1920x1080, 2-frame synthetic
   sequence with the trained Luma QP22/27/32/37 and Chroma QP22 predictors
   at batch 512, then check the PartitionMat files and that K8 was launched.
4. The same port on 16 CTUs on the CPU and on the card: raw maps within
   RAW_TOL, voted QT maps equal except next to a rounding threshold.
5. One Luma ``predict`` of the main path's CTUs under torch.profiler: device
   time by kernel and the device's idle share.

Prints the kernels' numbers as one JSON line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Exits non-zero without
CUDA.
"""
from __future__ import annotations

import itertools
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pmp_vvc_tpu_torch import _build
from pmp_vvc_tpu_torch.data.synthcontent import natural_sequence
from pmp_vvc_tpu_torch.data.yuv import blocks_for_sequence, write_yuv420
from pmp_vvc_tpu_torch.pmp.pipeline import predict_sequence
from pmp_vvc_tpu_torch.pmp.predict import CompPredictor
from pmp_vvc_tpu_torch.pmp.structural import (
    structural_vote, structural_vote_reference)

REPO = pathlib.Path(__file__).resolve().parent
CKPT = REPO / "trained_models" / "bd"
W, H, FRAMES = 1920, 1080, 2          # JVET CTC class-B geometry
PREDICTORS = (("Luma", 22), ("Luma", 27), ("Luma", 32), ("Luma", 37),
              ("Chroma", 22))
BATCH = 512
VOTE_N = 65_536
HBM_BYTES_PER_S = 3.35e12             # H100 SXM, data sheet
FP32_OPS_PER_S = 67e12                # H100 SXM float32 outside tensor cores
# Card against CPU, both float32 with TF32 off. The convolutions sum up to
# 1,600 terms in another order on each side, and cuDNN may pick Winograd or
# FFT algorithms whose float32 error exceeds a direct sum's. The CPU port
# agrees with the JAX nets within 1e-4 (tests/test_torch_models.py); 1e-3 on
# outputs of size ~1 allows for the card's algorithms with a margin.
RAW_TOL = 1e-3

# Scalar float32 operations of the K8 kernel per CTU, counted from
# csrc/structural_vote.cu: 48 max + 16 round + 32 clamp + 16 zero tests for
# every map; case A (num0 <= 12) adds 16 promotions + 4 x (4 adds + 4 tests
# + 2 range tests + 4 selects); case B (12 < num0 < 16) adds 16 stores.
OPS_COMMON, OPS_CASE_A, OPS_CASE_B = 112, 72, 16


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def vote_inputs(n: int, seed: int = 0) -> np.ndarray:
    """(n, 8, 8) float32 raw QT maps covering the vote's cases.

    Every 2x2 pattern of one quadrant in each quadrant position, maps with
    each zero count 0..16, exact k+0.5 ties, all-zero maps, then random fill.
    """
    rng = np.random.RandomState(seed)
    pat = np.array(list(itertools.product(range(4), repeat=4))).reshape(-1, 2, 2)
    quads = rng.randint(0, 4, (4, len(pat), 4, 4))
    for q in range(4):
        r, c = 2 * (q >> 1), 2 * (q & 1)
        quads[q, :, r:r + 2, c:c + 2] = pat
    bands = rng.randint(1, 4, (17, 64, 16))
    for k in range(17):
        for m in bands[k]:
            m[rng.permutation(16)[:k]] = 0
    targets = np.concatenate([quads.reshape(-1, 4, 4),
                              bands.reshape(-1, 4, 4)]).astype(np.float64)
    # raw values whose 2x2 max rounds (and clamps) to the target pooled value
    up = targets.repeat(2, axis=1).repeat(2, axis=2)
    raw = up + rng.uniform(-0.45, 0.45, up.shape)
    raw = np.where(up == 0, rng.uniform(-3.0, 0.45, up.shape), raw)
    raw = np.where(up == 3, rng.uniform(2.55, 6.0, up.shape), raw)
    ties = rng.choice([-1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 0.0, 1.0, 2.0, 3.0],
                      (512, 8, 8))
    zeros = np.zeros((64, 8, 8))
    fill = rng.randn(max(0, n - len(raw) - len(ties) - len(zeros)), 8, 8) * 1.5 + 1.0
    return np.concatenate([raw, ties, zeros, fill])[:n].astype(np.float32)


def vote_ops(x: torch.Tensor) -> int:
    """Scalar operations the K8 kernel does on these maps (data-dependent)."""
    pooled = x.reshape(-1, 4, 2, 4, 2).amax(dim=(2, 4)).round().clamp(0, 3)
    num0 = (pooled == 0).sum(dim=(1, 2))
    case_a = int((num0 <= 12).sum())
    case_b = int(((num0 > 12) & (num0 < 16)).sum())
    return OPS_COMMON * x.shape[0] + OPS_CASE_A * case_a + OPS_CASE_B * case_b


def _events_ms(run, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(fn, iters: int) -> float:
    """Time per call of ``fn`` called back to back from Python (CUDA events).

    At small sizes this is the host's dispatch time, not the device's.
    """
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    return _events_ms(fn, iters)


def graph_ms(fn, reps: int = 50, iters: int = 20) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed, so that no host dispatch sits between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, iters) / reps


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(logs)} kernel(s) in {time.perf_counter() - t0:.2f} s")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def phase_vote() -> dict:
    x = torch.from_numpy(vote_inputs(VOTE_N, seed=0)).cuda()
    got = structural_vote(x)
    want = structural_vote_reference(x)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"K8 differs from its plain version (max {err})")
    log(f"[K8] {VOTE_N} maps equal to the plain version on the card "
        f"(max_abs_err {err})")
    res = {}
    for n in (BATCH, VOTE_N):
        xn = x[:n].contiguous()
        nbytes = 2 * xn.numel() * 4
        ops = vote_ops(xn)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / FP32_OPS_PER_S else "operations"
        kernel, plain = (lambda: structural_vote(xn)), (lambda: structural_vote_reference(xn))
        ms, plain_ms = graph_ms(kernel), graph_ms(plain)
        call, plain_call = call_ms(kernel, 2000), call_ms(plain, 200)
        log(f"[K8] N={n}: device time per call (CUDA graph) kernel {ms:.6f} ms, "
            f"plain {plain_ms:.6f} ms; called from Python kernel {call:.6f} ms, "
            f"plain {plain_call:.6f} ms; bound {bound:.6f} ms by {by} "
            f"({nbytes} B, {ops} ops)")
        res[n] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    res["max_abs_err"] = err
    return res


def phase_main_path(tmp: pathlib.Path):
    frames = natural_sequence(W, H, FRAMES, seed0=7, bit_depth=8)
    y, u, v = (np.stack([f[i] for f in frames]).astype(np.uint8) for i in range(3))
    yuv = tmp / f"natural_{W}x{H}.yuv"
    write_yuv420(yuv, y, u, v)
    t0 = time.perf_counter()
    preds = {(comp, qp): CompPredictor.from_trained(
        comp == "Luma", CKPT / f"{comp}_Q_QP{qp}.msgpack",
        CKPT / f"{comp}_BD_QP{qp}.msgpack") for comp, qp in PREDICTORS}
    log(f"[main] loaded {len(preds)} predictors in {time.perf_counter() - t0:.2f} s")
    # One cold run first, so the measured run sees loaded CUDA modules.
    run = dict(predictors=preds, seq_name="natural", subsample=1,
               qps=(22, 27, 32, 37))
    cold = predict_sequence(yuv, W, H, out_dir=tmp / "cold", **run)
    log(f"[main] cold run: net {sum(cold.net.values()):.3f} s, "
        f"post {sum(cold.post.values()):.3f} s")

    structural_vote.launches = 0
    times = predict_sequence(yuv, W, H, out_dir=tmp / "out", **run)
    launches = structural_vote.launches
    check(launches > 0, "K8 was not launched on the main path")

    ctus = FRAMES * (W // 64) * (H // 64)
    log(f"[main] {W}x{H} x {FRAMES} frames, {ctus} CTUs per predictor, "
        f"batch {BATCH}; K8 launches {launches}")
    log(f"[main] blocking {times.blocking:.4f} s")
    for key in times.net:
        log(f"[main] {key[0]} QP{key[1]}: net {times.net[key]:.4f} s "
            f"({ctus / times.net[key]:.1f} CTU/s), post {times.post[key]:.4f} s")
    total_net = sum(times.net.values())
    log(f"[main] net stage: {len(times.net) * ctus / total_net:.1f} CTU "
        f"predictions/s over {len(times.net)} predictors")

    hp, wp = H // 64 * 64, W // 64 * 64
    q4, q8 = hp // 4 * wp // 4, hp // 8 * wp // 8
    per_frame = 2 * q4 + q8 + 3 * q4
    for comp, qp in PREDICTORS:
        path = tmp / "out" / f"natural_{comp}_QP{qp}_PartitionMat.txt"
        vals = np.array(path.read_bytes().split(), dtype=np.int64)
        check(len(vals) == FRAMES * per_frame,
              f"{path.name}: {len(vals)} lines, want {FRAMES * per_frame}")
        f = vals.reshape(FRAMES, per_frame)
        check(np.isin(f[:, :2 * q4], (0, 1)).all(), f"{path.name}: edge values")
        check(np.isin(f[:, 2 * q4:2 * q4 + q8], (0, 1, 2, 3)).all(),
              f"{path.name}: QT depths")
        check(np.isin(f[:, 2 * q4 + q8:], (-1, 0, 1)).all(),
              f"{path.name}: directions")
    log(f"[main] {len(PREDICTORS)} PartitionMat files of {per_frame} lines "
        f"per frame")
    return preds, blocks_for_sequence(y, u, v), launches


def phase_cpu_vs_card(preds: dict, blocks) -> None:
    luma_in, chroma_in = blocks
    for comp, qp in PREDICTORS:
        x = luma_in if comp == "Luma" else chroma_in
        x = x[np.linspace(0, len(x) - 1, 16).astype(int)]
        cpu = CompPredictor.from_trained(
            comp == "Luma", CKPT / f"{comp}_Q_QP{qp}.msgpack",
            CKPT / f"{comp}_BD_QP{qp}.msgpack", device="cpu")
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
        raw_cpu = [t.numpy() for t in cpu.forward(xt)]
        raw_gpu = [t.cpu().numpy() for t in preds[(comp, qp)].forward(xt.cuda())]
        errs = [float(np.abs(a - b).max()) for a, b in zip(raw_cpu, raw_gpu)]
        check(max(errs) <= RAW_TOL, f"{comp} QP{qp}: raw maps differ by {errs}")
        qt_cpu = cpu.predict(x)[0]
        qt_gpu = preds[(comp, qp)].predict(x)[0]
        pooled = raw_cpu[0].reshape(-1, 4, 2, 4, 2).max(axis=(2, 4))
        near = np.abs(pooled - np.floor(pooled) - 0.5) < RAW_TOL
        exempt = near.any(axis=(1, 2))
        same = (qt_cpu == qt_gpu).all(axis=(1, 2))
        check(bool((same | exempt).all()),
              f"{comp} QP{qp}: voted QT maps differ away from a threshold")
        log(f"[cpu-vs-card] {comp} QP{qp}: max |raw diff| qt {errs[0]:.3g} "
            f"bt {errs[1]:.3g} dire {errs[2]:.3g} (tol {RAW_TOL}); voted QT "
            f"equal on {int(same.sum())}/16 maps; {int(near.sum())} pooled "
            f"values within tol of a rounding threshold")


def phase_profile(preds: dict, blocks) -> None:
    """Where the net stage's time goes: one Luma QP32 ``predict`` of the
    main path's CTUs under torch.profiler, device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, pred = blocks[0], preds[("Luma", 32)]
    pred.predict(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict(x)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    if not rows:
        log("[profile] the profiler recorded no device time: not measured")
        return
    busy = sum(r[0] for r in rows)
    log(f"[profile] Luma QP32 predict, {len(x)} CTUs: wall {wall_ms:.3f} ms, "
        f"device busy {busy:.3f} ms, idle share {1 - busy / wall_ms:.3f}")
    for ms, count, name in rows[:12]:
        log(f"[profile]   {ms:9.3f} ms  x{count:<4d} {name[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    phase_build()
    vote = phase_vote()
    with tempfile.TemporaryDirectory(prefix="pmp_chip_smoke_") as tmp:
        preds, blocks, launches = phase_main_path(pathlib.Path(tmp))
    phase_cpu_vs_card(preds, blocks)
    phase_profile(preds, blocks)

    kernels = [{
        "name": "structural_vote", "route": "cuda",
        "source": "pmp_vvc_tpu_torch/csrc/structural_vote.cu",
        "replaces": "pmp_vvc_tpu/pmp/structural.py:39",
        "launches": launches, "max_abs_err": vote["max_abs_err"],
        **vote[BATCH], "library_ms": None,
    }]
    log(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
