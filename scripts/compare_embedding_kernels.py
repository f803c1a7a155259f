#!/usr/bin/env python3
"""Time this checkout's take-backward and cache-install CUDA kernels
against an earlier ``deepfm_tpu_torch/csrc/embedding.cu`` whose C interface
takes one table a launch, on one GPU.

    git show <rev>:deepfm_tpu_torch/csrc/embedding.cu > old_embedding.cu
    python3 scripts/compare_embedding_kernels.py --baseline old_embedding.cu

Both sources build with the port's nvcc flags, in parallel, into a
temporary directory. Both take backwards are checked against the numpy
ascending-position oracle at the hashed step's four tables, and this
checkout's install against ``reference_install`` at the tier's four slot
cases. Then each case is timed (device time per call, torch.profiler) in
turns baseline, this, this, baseline, at ``chip_smoke.py``'s shapes: the
take backward over the hashed step's four masked tables at D = 1 and 32
(the baseline: one launch per table) and over one table, and the install
of fm_w (D = 1) and fm_v (D = 32) sharing one transaction's slots (the
baseline: one launch per table), and of each table alone. The card's name
and power limit come first. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke as cs  # noqa: E402
from deepfm_tpu_torch import _native  # noqa: E402
from deepfm_tpu_torch.ops import embedding_kernels as ek  # noqa: E402


def build(sources: dict, out_dir: str) -> dict:
    """{name: loaded library} of ``sources`` ({name: .cu path})."""
    procs = {name: subprocess.Popen(
        [_native.nvcc_path(), *_native.NVCC_FLAGS, "-o",
         os.path.join(out_dir, f"{name}.so"), path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, path in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
    return libs


def bind_one_table(lib) -> None:
    """The one-table-a-launch C interface: dfm_take_bwd(g, order, starts,
    out, u, d, dtype, stream), dfm_install(w, m, v, tau, slots, wv, mv, vv,
    tv, h, p, d, stream)."""
    p = ctypes.c_void_p
    lib.dfm_take_bwd.argtypes = [p] * 4 + [ctypes.c_int64] * 2 + [
        ctypes.c_int, p]
    lib.dfm_install.argtypes = [p] * 9 + [ctypes.c_int64] * 3 + [p]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True,
                    help="an earlier embedding.cu (one table a launch)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_embedding_kernels: no CUDA device visible to torch",
              file=sys.stderr)
        return 2
    print(cs.card_line())
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        libs = build({"this": _native._source("embedding"),
                      "baseline": args.baseline}, tmp)
        _native._bind_embedding(libs["this"])
        bind_one_table(libs["baseline"])
        _native._libs["embedding"] = libs["this"]
        base = libs["baseline"]

        rng = np.random.default_rng(cs.SEED + 60)
        ids, masks = cs.hashed_step_ids(rng)
        n = cs.PLAN_N
        plans = ek.plan_build_tables(
            torch.from_numpy(ids).to(dev), [cs.HASHED_ROWS] * cs.HASHED_TABLES,
            [torch.from_numpy(m).to(dev) for m in masks])
        inv = [p.inv for p in plans]
        keep = [p.mask > 0 for p in plans]
        segs = ek.position_segments_tables(torch.stack(inv), n,
                                           torch.stack(keep))
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 61)
        gs = {d: torch.randn(n, d, device=dev, generator=gen)
              for d in (1, 32)}

        def base_bwd(g, seg):
            out = torch.empty(n, g.shape[1], device=dev)
            err = base.dfm_take_bwd(g.data_ptr(), seg[0].data_ptr(),
                                    seg[1].data_ptr(), out.data_ptr(), n,
                                    g.shape[1], 0, stream())
            _native.check(err, "baseline take backward")
            return out

        for d, g in gs.items():
            got = ek._launch_take_bwd_tables(g, segs, [n] * len(segs))
            for i, seg in enumerate(segs):
                oracle = cs.take_bwd_oracle(g, inv[i], keep[i], n)
                for name, x in (("this", got[i]), ("baseline",
                                                    base_bwd(g, seg))):
                    assert np.array_equal(x.cpu().numpy(), oracle), (name,
                                                                     d, i)
        for kind in (cs.INSTALL_I, 1, "out_of_range", "all"):
            sl = cs.install_case_slots(kind, cs.INSTALL_H, rng)
            ons = [{k: torch.from_numpy(v).to(dev) for k, v in
                    cs.install_inputs(cs.INSTALL_H, d, sl, rng).items()}
                   for d in cs.INSTALL_WIDTHS]
            ref = [{k: v.clone() for k, v in o.items()} for o in ons]
            tables, values = cs._install_split(ons)
            ek._launch_install_tables(tables, ons[0]["slots"], values)
            for r in ref:
                ek.reference_install(*(r[k] for k in cs.INSTALL_ARGS))
            torch.cuda.synchronize()
            for o, r in zip(ons, ref):
                for k in cs.INSTALL_ARGS[:4]:
                    assert torch.equal(o[k], r[k]), (kind, k)
        print("checks: both take backwards bit-equal to the numpy oracle; "
              "the install bit-equal to reference_install at four slot "
              "cases")

        sl = cs.install_case_slots(cs.INSTALL_I, cs.INSTALL_H, rng)
        ons = [{k: torch.from_numpy(v).to(dev) for k, v in cs.install_inputs(
            cs.INSTALL_H, d, sl, rng).items()} for d in cs.INSTALL_WIDTHS]
        slots = ons[0]["slots"]

        def base_install(part):
            for o in part:
                d = 1 if o["w"].dim() == 1 else o["w"].shape[1]
                err = base.dfm_install(
                    *(o[k].data_ptr() for k in cs.INSTALL_ARGS),
                    cs.INSTALL_H, slots.shape[0], d, stream())
                _native.check(err, "baseline install")

        cases = {}
        for d, g in gs.items():
            cases[f"take_bwd T={len(segs)} D={d}"] = (
                lambda g=g: ek._launch_take_bwd_tables(g, segs,
                                                       [n] * len(segs)),
                lambda g=g: [base_bwd(g, s) for s in segs])
            cases[f"take_bwd T=1 D={d}"] = (
                lambda g=g: ek._launch_take_bwd(g, segs[0], n),
                lambda g=g: base_bwd(g, segs[0]))
        for label, part in (("D=1+32", ons), ("D=1", ons[:1]),
                            ("D=32", ons[1:])):
            tables, values = cs._install_split(part)
            cases[f"install {label}"] = (
                lambda t=tables, v=values: ek._launch_install_tables(
                    t, slots, v),
                lambda part=part: base_install(part))
        times = {}
        for turn in ("baseline", "this", "this", "baseline"):
            for name, fns in cases.items():
                fn = fns[0] if turn == "this" else fns[1]
                times.setdefault((name, turn), []).append(cs.timed(fn)[0])
        for name in cases:
            print(f"{name}: this_ms=" + " / ".join(
                f"{x:.6f}" for x in times[(name, "this")]) + " baseline_ms="
                + " / ".join(f"{x:.6f}" for x in times[(name, "baseline")])
                + " (device time per call; the baseline launches once per "
                "table)")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
