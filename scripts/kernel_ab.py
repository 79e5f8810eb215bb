#!/usr/bin/env python3
"""Time a grid-evaluation kernel against the one it replaced, on one GPU.

    mkdir -p .smoke-ab && git show 425e202:volumetricinterp_tpu_torch/csrc/grid_eval.cu \\
        > .smoke-ab/old.cu
    python3 scripts/kernel_ab.py --old .smoke-ab/old.cu [--out ab.json]
    python3 scripts/kernel_ab.py --highorder [--out ab.json]

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

``--highorder`` does the same at BASELINE config 3's order, (maxl, maxk) =
(10, 12), and chip_smoke.py's phase 11 (f) shapes (HI_KERNEL_SHAPES): the
old side is grid_eval.cu's own (10, 12) instantiation, built here with
grid_eval_cuda.nvcc and the defines it had before the tiled kernel took the
order (one point a thread, one block an SM) and launched once per record
chunk; the new side is grid_eval_tiled.cu through ``eval_records``.  It
also prints whether the two give the same bits.
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


def register_build(order):
    """grid_eval.cu's own instantiation of ``order`` (KernelConfig with
    tiled False, at the points a thread and blocks an SM its live state
    gives), built and launched through grid_eval_cuda; returns (evaluate,
    build info)."""
    cfg = gec.KernelConfig(order[0], -(-order[1] // 4) * 4, 1)
    info = gec.build(cfg)

    def evaluate(lat, lon, alt, ceff, ev, inside):
        out = torch.empty((ceff.shape[0], lat.shape[0]), dtype=torch.float32,
                          device=lat.device)
        gec.launch_records(cfg, lat, lon, alt, ceff, ev, inside, out)
        return out

    return evaluate, info


def highorder(args, result):
    """--highorder: grid_eval.cu's (10, 12) build against grid_eval_tiled.cu
    at phase 11 (f)'s shapes, in turns."""
    new_cfg = gec.kernel_config(*cs.HI_ORDER)
    old_eval, old_info = register_build(cs.HI_ORDER)
    new_info = gec.build(new_cfg)
    for name, info, kernel in (("old", old_info, "grid_eval_kernel"),
                               ("new", new_info, "grid_eval_tiled_kernel")):
        regs, spills = cs.ptxas_usage(Path(info["log"]).read_text())
        result["builds"][name] = {
            "config": str(info["config"]), "seconds": info["seconds"],
            "registers": regs, "spill_bytes": spills,
            "sass": sass_counts(info["path"], kernel)}
    print_builds(result)
    variants = {"old": old_eval, "new": gec.eval_records}
    for label, axes, nrec, mask in cs.HI_KERNEL_SHAPES:
        ev, pts32, pts64, ceff32, ceff64, inside = cs.kernel_inputs(
            axes, nrec, mask, "cuda", order=cs.HI_ORDER)
        run_shape(args, result, variants, label, ev, pts32, pts64, ceff32,
                  ceff64, inside)
        del ev, pts32, pts64, ceff32, ceff64, inside
        torch.cuda.empty_cache()


def print_builds(result):
    for name, b in result["builds"].items():
        loops = [lp for lp in b["sass"]["loops"] if lp["FFMA"]]
        print(f"build {name}: " + json.dumps(
            {k: v for k, v in b.items() if k != "sass"}) + " sass " + json.dumps(
            {k: v for k, v in b["sass"].items() if k != "loops"})
            + " loops with FFMA " + json.dumps(loops), flush=True)


def run_shape(args, result, variants, label, ev, pts32, pts64, ceff32, ceff64,
              inside):
    """Every variant against the float64 twin, then timed in turns (old,
    new, new, old)."""
    npts, nrec = pts32[0].numel(), ceff32.shape[0]
    ref = gec.eval_records_plain(*pts64, ceff64, ev, inside)
    n_live = int((~torch.isnan(ref[0])).sum())
    flop, nbytes = cs.kernel_work(ev, npts, nrec, n_live, inside is not None)
    b_ms, b_by = cs.bound_ms(flop, nbytes)
    row = {"shape": label, "npts": npts, "nrec": nrec, "n_live": n_live,
           "flop": flop, "bytes": nbytes, "bound_ms": b_ms,
           "bound_by": b_by, "err_of_sup": {}, "ms": {k: [] for k in variants}}
    outs = {}
    for name, fn in variants.items():
        outs[name] = fn(*pts32, ceff32, ev, inside)
        err, sup = cs.held_against_twin(outs[name], ref, f"{name} {label}")
        row["err_of_sup"][name] = err / sup
    del ref
    a, b = outs.values()
    row["same_bits"] = bool(torch.equal(torch.isnan(a), torch.isnan(b)) and
                            torch.equal(torch.nan_to_num(a).view(torch.int32),
                                        torch.nan_to_num(b).view(torch.int32)))
    del outs, a, b
    for name in ("old", "new", "new", "old"):
        row["ms"][name].append(cs.cuda_ms(
            lambda: variants[name](*pts32, ceff32, ev, inside), args.reps))
    print(f"{label}: bound {b_ms:.4f} ms ({b_by}); " + "; ".join(
        f"{k} {' '.join(f'{t:.4f}' for t in v)} ms (share "
        f"{b_ms / min(v):.3f}, err {row['err_of_sup'][k]:.3e} of sup)"
        for k, v in row["ms"].items()) + f"; same bits {row['same_bits']}",
        flush=True)
    result["shapes"].append(row)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--old",
                       help="a kernel source with the first port's C interface")
    which.add_argument("--highorder", action="store_true",
                       help="grid_eval.cu's (10, 12) build against the tiled "
                            "kernel")
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
    if args.highorder:
        highorder(args, result)
        if args.out:
            Path(args.out).write_text(json.dumps(result, indent=1))
        return
    info = gec.build(prod)
    regs, spills = cs.ptxas_usage(Path(info["log"]).read_text())
    old_eval, old_so, old_seconds = build_old(args.old)
    result["builds"] = {
        "old": {"seconds": old_seconds, "sass": sass_counts(
            old_so, f"grid_eval_kernelILi{prod.maxl}ELi4E")},
        "new": {"config": str(prod), "seconds": info["seconds"],
                "registers": regs, "spill_bytes": spills,
                "sass": sass_counts(info["path"], "grid_eval_kernel")}}
    print_builds(result)
    variants = {"old": old_eval, "new": gec.eval_records}
    for label, axes, nrec, mask in cs.KERNEL_SHAPES:
        ev, pts32, pts64, ceff32, ceff64, inside = cs.kernel_inputs(
            axes, nrec, mask, "cuda")
        run_shape(args, result, variants, label, ev, pts32, pts64, ceff32,
                  ceff64, inside)
        del ev, pts32, pts64, ceff32, ceff64, inside
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
