"""Console entry points of the PyTorch port (volumetricinterp_tpu/cli.py,
reference run_volumetricinterp.py:14-35 and run_validate.py:16-28).

    volumetricinterp-torch [--validate] config.ini [--device cpu]

--validate fits the [VALIDATE] window and draws its maps (validate_main is
the same route alone), --starttime/--endtime window the fit, --resume
continues a partially written output file, --profile prints the phase
times, --device picks the device (cuda by default; the CPU runs only when
asked for).  --distributed joins a torch.distributed world (one process a
card, parallel/distributed.py: torchrun's variables or VITPU_COORDINATOR /
VITPU_NUM_PROCESSES / VITPU_PROCESS_ID) and shards the fit over it;
process 0 writes the output file.
"""

from __future__ import annotations

import datetime as dt
from argparse import ArgumentParser, RawTextHelpFormatter

description = (
    "Calculate coefficients for volmetric interpolation of a scalar "
    "quantity in a fitted AMISR file."
)


def _config_help():
    """The help text: the keys of the packaged example configuration."""
    import importlib.resources as res

    text = (res.files("volumetricinterp_tpu_torch")
            .joinpath("example_config.ini").read_text())
    body = "".join(
        line for line in text.splitlines(keepends=True)
        if not line.startswith("#") and len(line.strip()) > 0
    )
    return "A configuration file that specifies the following parameters:\n" + body


def main(argv=None):
    parser = ArgumentParser(description=description,
                            formatter_class=RawTextHelpFormatter)
    parser.add_argument("config_file", help=_config_help())
    parser.add_argument("--validate", action="store_true",
                        help="fit the [VALIDATE] window and draw its maps")
    parser.add_argument("--starttime", default=None,
                        help="ISO start time (overrides full-file fit)")
    parser.add_argument("--endtime", default=None, help="ISO end time")
    parser.add_argument("--resume", action="store_true",
                        help="checkpointed mode: flush each record chunk to "
                             "the output file and resume a partial run")
    parser.add_argument("--profile", action="store_true",
                        help="print per-phase wall times at the end")
    parser.add_argument("--distributed", action="store_true",
                        help="join a torch.distributed world (torchrun, or "
                             "VITPU_COORDINATOR / VITPU_NUM_PROCESSES / "
                             "VITPU_PROCESS_ID) and shard the fit over it: "
                             "records over processes, points inside a row "
                             "of [TPU] MESH_RECORDS x MESH_POINTS")
    _device_arg(parser)
    args = vars(parser.parse_args(argv))

    if args["validate"]:
        _validate(args)
        return
    if not args["distributed"]:
        _fit(args, args["device"])
        return

    import torch.distributed as dist

    from .parallel.distributed import initialize_distributed, local_device

    owned = not dist.is_initialized()
    pid, nproc = initialize_distributed(device=args["device"])
    print(f"distributed: process {pid} / {nproc}")
    try:
        _fit(args, local_device(args["device"]))
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def _fit(args, device):
    from .interpolate import Interpolate

    interp = Interpolate(args["config_file"], device=device)
    st = (dt.datetime.fromisoformat(args["starttime"])
          if args["starttime"] else None)
    et = dt.datetime.fromisoformat(args["endtime"]) if args["endtime"] else None
    interp.calc_coeffs(starttime=st, endtime=et, resume=args["resume"])
    interp.saveh5()
    if args["profile"]:
        for k, v in interp.timer.report().items():
            print(f"{k:24s} {v:8.3f} s")


def _device_arg(parser):
    parser.add_argument("--device", default="cuda",
                        help="torch device of the fit (default cuda; pass "
                             "cpu to run on the CPU)")


def _validate(args):
    from .validate import Validate

    validate = Validate(args["config_file"], device=args["device"])
    validate.interpolate()
    validate.create_plots()


def validate_main(argv=None):
    """Standalone validation entry (reference run_validate.py:16-28)."""
    parser = ArgumentParser(
        description=(
            "Validate parameters in a config file by interpolating and "
            "plotting a short time window."
        ),
        formatter_class=RawTextHelpFormatter,
    )
    parser.add_argument("config_file", help=_config_help())
    _device_arg(parser)
    _validate(vars(parser.parse_args(argv)))


if __name__ == "__main__":
    main()
