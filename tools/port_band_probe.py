#!/usr/bin/env python3
"""Where the band route's factor-solve spends its time, on one CUDA card.

    python tools/port_band_probe.py [--n 1024] [--bands 0 1 2 3 4 5]

Builds ``boslam_torch/ops/csrc/band_cholesky.cuh`` with
-DBOSLAM_BAND_PROFILE (the kernel then sums clock64() cycles of each part
of its sweep) into build/band_probe/, runs it on random SPD systems whose
band is bt tiles (n x n, condition ~1e3), checks x against the plain band
solve, and prints one JSON line per band: the probe call's time by CUDA
events (two small copies, the kernel and a stream sync; median of 20), and
the cycles and microseconds (at the card's maximum SM clock) of each part
of the sweep, per panel (the prologue and the backward sweep in all):
thread 0's chain product L_c+1,c, its publication (put and barriers), the
look-ahead update, the one-warp factor and its wait at the panel's end;
warps 1-3's work (y, the inverse's store, the next tile row); a product
team's wait for L_c+1,c, its panel tiles and its trailing update.  The
profiled build is not the one the port runs: its clock reads add a little
to each part.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SRC = r'''
#include "band_cholesky.cuh"
extern "C" int band_probe(float *L, float *Linv, const float *b, float *x, const float *mask,
                          int n, int bt, unsigned long long *out, void *stream) {
  const unsigned long long zero[boslam::band::PROF_SLOTS] = {};
  cudaError_t err = cudaMemcpyToSymbol(boslam::band::band_prof, zero, sizeof(zero));
  if (err != cudaSuccess) return (int)err;
  err = boslam::band::factor_solve(L, Linv, b, x, mask, n, bt, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaStreamSynchronize((cudaStream_t)stream)) != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(out, boslam::band::band_prof, sizeof(boslam::band::band_prof));
}
'''
PARTS = ("prologue", "chain_product", "chain_publish", "lookahead", "factor", "wait_end",
         "backward", "warps_1_3", "products_wait", "products_panel", "products_trailing")


def _build():
    from boslam_torch.ops import _build as B

    out = ROOT / "build" / "band_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(SRC)
    lib = out / "libband_probe.so"
    log = subprocess.run([B._nvcc(), *B.NVCC_FLAGS, "-DBOSLAM_BAND_PROFILE", "-I", str(B.CSRC),
                          "-o", str(lib), str(out / "probe.cu")], capture_output=True, text=True)
    if log.returncode:
        raise RuntimeError(f"nvcc failed:\n{log.stdout}{log.stderr}")
    for line in (log.stdout + log.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")
    fn = ctypes.CDLL(str(lib)).band_probe
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _banded_spd(n, bt, rng):
    A = rng.standard_normal((n, n)).astype(np.float32)
    i, j = np.indices((n, n))
    A[np.abs(i // 32 - j // 32) > bt] = 0.0
    A = np.tril(A)
    return (A + A.T) / 2 + np.float32(n / 4) * np.eye(n, dtype=np.float32)


def main() -> int:
    import torch

    from boslam_torch.ops import cholesky as chol

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--bands", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 2
    probe = _build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"],
                               capture_output=True, text=True).stdout.split()[0])
    clock_khz = mhz * 1e3
    print(f"card: {card}, max SM clock {mhz:.0f} MHz (microseconds below are at it)")
    rng = np.random.default_rng(0)
    n, nb = args.n, args.n // chol.TILE
    stream = torch.cuda.current_stream().cuda_stream
    for bt in args.bands:
        H = torch.from_numpy(_banded_spd(n, bt, rng)).cuda()
        b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
        mask = torch.ones(n, device="cuda")
        Linv = torch.empty((nb, chol.TILE, chol.TILE), device="cuda")
        x = torch.empty(n, device="cuda")
        cyc = (ctypes.c_ulonglong * len(PARTS))()

        def run(L):
            err = probe(L.data_ptr(), Linv.data_ptr(), b.data_ptr(), x.data_ptr(),
                        mask.data_ptr(), n, bt, ctypes.cast(cyc, ctypes.c_void_p), stream)
            if err:
                raise RuntimeError(f"band probe: CUDA error {err}")

        run(H.clone())
        want = chol.blocked_substitute(*(lambda L: (L, chol.blocked_factor(L, bt)))(H.clone()),
                                       b, mask, bt)
        err = (x - want).abs().max().item()
        times = []
        for _ in range(20):
            L = H.clone()
            torch.cuda.synchronize()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            run(L)
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        parts = dict(zip(PARTS, (int(c) for c in cyc)))
        per = {k: v / (1 if k in ("prologue", "backward") else nb) for k, v in parts.items()}
        print(json.dumps(dict(
            n=n, band_tiles=bt, max_abs_err_vs_plain=err, probe_call_ms=float(np.median(times)),
            cycles=parts, us={k: v / clock_khz * 1e3 for k, v in per.items()})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
