#!/usr/bin/env python3
"""Time the grid-evaluation kernel against the first port's kernel, on one GPU.

    mkdir -p .smoke-ab && git show 425e202:volumetricinterp_tpu_torch/csrc/grid_eval.cu \\
        > .smoke-ab/old.cu
    python3 scripts/kernel_ab.py --old .smoke-ab/old.cu [--out ab.json]

``--old`` is a source with the first port's C interface (commit 425e202):
vi_grid_eval_records taking coef [degree, npairs] with the pair degrees,
ceff [nrec, 2, npairs, maxk] unpadded, and every record in one call; it is
built whole, every instantiation.  At each of chip_smoke.py's phase 3
shapes (production order, random records) the script runs the old kernel
and the current one (through ``eval_records``) in turns, old, new, new,
old, holds every run against the float64 twin (5e-5 of the sup, NaN sets
equal) and prints the CUDA-event times beside the bound of
chip_smoke.kernel_work.  For both builds it prints static SASS counts
(cuobjdump -sass) of the production kernel: all instructions, FFMA and
LDS, in the whole kernel and in each loop body; ``--out`` writes it all as
JSON.
"""

import argparse
import ctypes
import hashlib
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from volumetricinterp_tpu_torch.ops import grid_eval_cuda as gec  # noqa: E402

INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
# a branch target: a label (nvdisasm) or an address (cuobjdump)
TARGET = re.compile(r"(\.L_x_\d+|\b0x[0-9a-f]+\b)")


def sass_counts(so, kernel):
    """Static counts of the first function whose name contains ``kernel``:
    {"all", "FFMA", "LDS", "LDS.128", "loops": [same counts per loop body]}."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    txt = subprocess.run([exe, "-sass", so], capture_output=True, text=True,
                         check=True).stdout
    funcs = txt.split("Function : ")[1:]
    body = next(f for f in funcs if kernel in f.splitlines()[0])
    instrs, labels, pending = [], {}, []
    for line in body.splitlines():
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            t = m.group(2).startswith("BRA") and TARGET.search(
                line[m.end():line.find(";")])
            if t and t.group(1).startswith("0x"):
                labels[t.group(1)] = int(t.group(1), 16)
            instrs.append((addr, m.group(2), t.group(1) if t else None))

    def count(sel):
        ops = [op for _, op, _ in sel]
        other = Counter(o.split(".")[0] for o in ops
                        if not o.startswith(("FFMA", "LDS")))
        return {"all": len(ops), "FFMA": sum(o.startswith("FFMA") for o in ops),
                "LDS": sum(o.startswith("LDS") for o in ops),
                "LDS.128": sum(o.startswith("LDS.128") for o in ops),
                "other": dict(other.most_common(6))}

    out = count(instrs)
    out["loops"] = [
        dict(count([i for i in instrs if labels[t] <= i[0] <= a]),
             start=hex(labels[t]), end=hex(a))
        for a, op, t in instrs
        if op.startswith("BRA") and t in labels and labels[t] <= a]
    return out


def build_old(src):
    """Builds the old source whole; returns (evaluate, library path,
    seconds of nvcc)."""
    digest = hashlib.sha256(Path(src).read_bytes()).hexdigest()[:16]
    so = gec.BUILD_DIR / f"ab_old_{digest}.so"
    seconds, _ = gec.nvcc(gec.NVCC_FLAGS, src, so)
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vi_grid_eval_records.argtypes = [
        P, P, P, P, P, P, P, P, ctypes.c_longlong, I, I, I, I,
        F, F, F, F, F, F, P]
    lib.vi_grid_eval_records.restype = I

    def evaluate(lat, lon, alt, ceff, ev, inside):
        npts, nrec = lat.shape[0], ceff.shape[0]
        out = torch.empty((nrec, npts), dtype=torch.float32, device=lat.device)
        pair_deg = torch.as_tensor(ev.pair_degree, dtype=torch.int32,
                                   device=lat.device)
        center, inv_half = gec.band_constants(ev, torch.float32)
        rc = lib.vi_grid_eval_records(
            lat.data_ptr(), lon.data_ptr(), alt.data_ptr(),
            None if inside is None else inside.view(torch.uint8).data_ptr(),
            ev.coef_device.data_ptr(), pair_deg.data_ptr(), ceff.data_ptr(),
            out.data_ptr(), npts, nrec, ev.degree, ev.maxl, ev.maxk, center,
            inv_half, *ev.rot, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"old kernel: CUDA error {rc}")
        return out

    return evaluate, str(so), seconds


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="a kernel source with the first port's C interface")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", help="write the results here as JSON")
    args = ap.parse_args()
    cs.phase_device()
    model = cs.Model(cs.Config.from_text(cs.MODEL_CFG))
    prod = gec.kernel_config(model.maxl, model.maxk)
    result = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), "builds": {},
        "shapes": []}
    info = gec.build(prod)
    regs, spills = cs.ptxas_usage(Path(info["log"]).read_text())
    old_eval, old_so, old_seconds = build_old(args.old)
    result["builds"] = {
        "old": {"seconds": old_seconds, "sass": sass_counts(
            old_so, f"grid_eval_kernelILi{prod.maxl}ELi4E")},
        "new": {"config": str(prod), "seconds": info["seconds"],
                "registers": regs, "spill_bytes": spills,
                "sass": sass_counts(info["path"], "grid_eval_kernel")}}
    for name, b in result["builds"].items():
        loops = [lp for lp in b["sass"]["loops"] if lp["FFMA"]]
        print(f"build {name}: " + json.dumps(
            {k: v for k, v in b.items() if k != "sass"}) + " sass " + json.dumps(
            {k: v for k, v in b["sass"].items() if k != "loops"})
            + " loops with FFMA " + json.dumps(loops), flush=True)
    variants = {"old": old_eval, "new": gec.eval_records}
    for label, axes, nrec, mask in cs.KERNEL_SHAPES:
        ev, pts32, pts64, ceff32, ceff64, inside = cs.kernel_inputs(
            axes, nrec, mask, "cuda")
        npts = pts32[0].numel()
        ref = gec.eval_records_plain(*pts64, ceff64, ev, inside)
        n_live = int((~torch.isnan(ref[0])).sum())
        flop, nbytes = cs.kernel_work(ev, npts, nrec, n_live, inside is not None)
        b_ms, b_by = cs.bound_ms(flop, nbytes)
        row = {"shape": label, "npts": npts, "nrec": nrec, "n_live": n_live,
               "flop": flop, "bytes": nbytes, "bound_ms": b_ms,
               "bound_by": b_by, "err_of_sup": {}, "ms": {k: [] for k in variants}}
        for name, fn in variants.items():
            err, sup = cs.held_against_twin(
                fn(*pts32, ceff32, ev, inside), ref, f"{name} {label}")
            row["err_of_sup"][name] = err / sup
        for name in ("old", "new", "new", "old"):
            row["ms"][name].append(cs.cuda_ms(
                lambda: variants[name](*pts32, ceff32, ev, inside), args.reps))
        print(f"{label}: bound {b_ms:.4f} ms ({b_by}); " + "; ".join(
            f"{k} {' '.join(f'{t:.4f}' for t in v)} ms (share "
            f"{b_ms / min(v):.3f}, err {row['err_of_sup'][k]:.3e} of sup)"
            for k, v in row["ms"].items()), flush=True)
        result["shapes"].append(row)
        del ev, pts32, pts64, ceff32, ceff64, inside, ref
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
