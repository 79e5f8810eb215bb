"""Typed configuration, shared verbatim with the JAX package.

The parser is a copy of ``volumetricinterp_tpu/config.py``: every key of
the reference's example_config.ini is accepted with identical semantics
and the raw text is kept verbatim, so a coefficient file written by either
package embeds config text the other re-parses byte for byte.

The optional [TPU] section parses in full.  This package honours
``REGPARAM_MODE``, ``QUAD_MODE``, ``TABLE_TOL``, ``TABLE_DOMAIN_FACTOR``,
``BASIS_IMPL`` and ``CHUNK_SIZE``; ``POINT_BUCKET``, ``MESH_*`` and
``GRID_EVAL_IMPL`` exist for XLA shape specialisation, TPU meshes and the
TPU kernel choice, and are ignored (one evaluator per device here).
Unsupported values are rejected where they are used, not here, so that any
file's embedded config still parses.
"""

from __future__ import annotations

import configparser
import datetime as dt
import io
import os
from dataclasses import dataclass, field


def _parse_float_list(s):
    return [float(i) for i in s.split(",")]


def _parse_int_list(s):
    return [int(i) for i in s.split(",")]


@dataclass
class FitConfig:
    """[DEFAULT] section — fit options (example_config.ini:3-27)."""

    param: str = "dens"
    filename: str = ""
    outputfilename: str = ""
    regularization_list: list = field(default_factory=list)
    regularization_method: str = "chi2"
    # optional data-informed regularization target: "chapman,<nmax>,<hmax_km>,
    # <scale_km>" pulls 0thorder-regularized fits toward a Chapman-layer
    # profile (the reference's IRI hint, sphharmlag.py:186; see
    # docs/ALGORITHM.md)
    regularization_profile: str = ""
    errlim: list = field(default_factory=lambda: [1e10, 1e13])
    goodfitcode: list = field(default_factory=lambda: [1, 2, 3, 4])
    chi2lim: list = field(default_factory=lambda: [0.1, 10.0])
    # time-dependent coefficients (ops/timesmooth.py — the reference's
    # "Adapt model to fit for time" TODO, sphharmlag.py:17):
    # TIME_SMOOTHING = gcv | <lambda float>; empty disables
    time_smoothing: str = ""
    time_knots: int = 0  # spline segments; 0 = auto (~nrec/4)
    # JOINTLY time-regularized fits (ops/timejoint.py): a first-difference
    # penalty coupling records inside the solve.  TIME_COUPLING =
    # <beta_rel> (coupling relative to the mean data-term scale); 0/empty
    # disables.  f32-grade on TPU by design (module docstring).
    time_coupling: float = 0.0


@dataclass
class ModelConfig:
    """[MODEL] section — basis parameters (example_config.ini:30-60)."""

    name: str = "sphharmlag"
    # sphharmlag keys
    maxk: int = 4
    maxl: int = 6
    cap_lim: float = 10.0  # degrees (converted to radians by the model)
    max_z_int: float = float("inf")
    latcp: float = 78.0
    loncp: float = 262.0
    # radbasfun keys
    eps: float = 100000.0
    latrange: list = field(default_factory=lambda: [74.0, 80.0])
    lonrange: list = field(default_factory=lambda: [260.0, 285.0])
    altrange: list = field(default_factory=lambda: [100.0, 600.0])
    numgridpnt: int = 7


@dataclass
class ValidateConfig:
    """[VALIDATE] section — plot window (example_config.ini:62-76)."""

    starttime: dt.datetime | None = None
    endtime: dt.datetime | None = None
    altitudes: list = field(default_factory=list)
    colorlim: list = field(default_factory=list)
    outpngname: str = "validate.png"


@dataclass
class TPUConfig:
    """[TPU] section — framework extensions (all optional).  The name and
    fields match the JAX package; see the module docstring for which
    fields this package reads."""

    basis_impl: str = "table"  # 'table' (Chebyshev, device) | 'series' (direct)
    quad_mode: str = "quad"  # 'quad' (host scipy, reference-exact) | 'gauss'
    table_domain_factor: float = 2.0  # theta table domain = factor * cap_lim
    table_tol: float = 1e-12  # Chebyshev truncation tolerance
    grid_eval_impl: str = "auto"  # 'auto' | 'pallas' | 'xla'
    # 'exact' (hybrid cutoff-semantics search, default) | 'exact_grid'
    # (full cutoff-eigh grid scan, receipts baseline) | 'fast' (whitened)
    regparam_mode: str = "exact"
    mesh_records: int = 0  # 0 = use all devices on the records axis
    mesh_points: int = 1
    chunk_size: int = 0  # records per incremental-flush chunk (0 = all)
    # pad the measurement-point axis up to a multiple of this, with
    # fully-masked (NaN-value, unit-error) points — the same weight-zero
    # masking the NaN QC path uses; results agree inside the documented
    # summation-order envelope (PARITY_NOTES #7/#8).  The
    # fit graph is compiled per (chunk, npoints) shape and a cold remote
    # compile costs minutes (docs/PERF.md section 3): bucketing lets
    # every AMISR file geometry within a bucket share one compiled
    # graph.  480 divides the production benchmark shape (2400), so the
    # shipped default changes nothing there.  0 disables.
    point_bucket: int = 480


@dataclass
class Config:
    fit: FitConfig
    model: ModelConfig
    validate: ValidateConfig
    tpu: TPUConfig
    raw_text: str = ""
    path: str = ""

    @classmethod
    def from_file(cls, config_file) -> "Config":
        """Load from a path, an open file object, or raw INI text.

        A string is treated as a path only when a file exists at it;
        otherwise it is parsed as INI text (so a legitimate one-line INI
        string never hits the filesystem).  A missing path still fails
        loudly: strings that *look* like a path (no newline, no '=' or
        '[' INI syntax) raise FileNotFoundError instead of being parsed
        as an empty config."""
        if hasattr(config_file, "read"):
            text = config_file.read()
            path = getattr(config_file, "name", "")
        elif isinstance(config_file, str) and os.path.exists(config_file):
            with open(config_file) as f:
                text = f.read()
            path = config_file
        elif isinstance(config_file, str) and (
            "\n" not in config_file
            and "=" not in config_file
            and "[" not in config_file
        ):
            raise FileNotFoundError(
                f"config file not found: {config_file!r}"
            )
        else:  # raw INI text
            text = config_file
            path = ""
        return cls.from_text(text, path=path)

    @classmethod
    def from_text(cls, text: str, path: str = "") -> "Config":
        cp = configparser.ConfigParser()
        cp.read_file(io.StringIO(text))

        fit = FitConfig()
        d = cp["DEFAULT"]
        if "PARAM" in d:
            fit.param = d.get("PARAM")
        if "FILENAME" in d:
            fit.filename = d.get("FILENAME")
        if "OUTPUTFILENAME" in d:
            fit.outputfilename = d.get("OUTPUTFILENAME")
        if "REGULARIZATION_LIST" in d:
            # reference semantics: comma split, empty entries dropped
            # (interpolate.py:76)
            fit.regularization_list = list(
                filter(None, d.get("REGULARIZATION_LIST").split(","))
            )
        if "REGULARIZATION_METHOD" in d:
            fit.regularization_method = d.get("REGULARIZATION_METHOD")
        if "REGULARIZATION_PROFILE" in d:
            fit.regularization_profile = d.get("REGULARIZATION_PROFILE")
        if "ERRLIM" in d:
            fit.errlim = _parse_float_list(d.get("ERRLIM"))
        if "GOODFITCODE" in d:
            fit.goodfitcode = _parse_int_list(d.get("GOODFITCODE"))
        if "CHI2LIM" in d:
            fit.chi2lim = _parse_float_list(d.get("CHI2LIM"))
        if "TIME_SMOOTHING" in d:
            fit.time_smoothing = d.get("TIME_SMOOTHING")
        if "TIME_KNOTS" in d:
            fit.time_knots = int(d.get("TIME_KNOTS"))
        if "TIME_COUPLING" in d:
            fit.time_coupling = float(d.get("TIME_COUPLING"))

        model = ModelConfig()
        if cp.has_section("MODEL"):
            m = cp["MODEL"]
            model.name = m.get("NAME", model.name)
            model.maxk = m.getint("MAXK", model.maxk)
            model.maxl = m.getint("MAXL", model.maxl)
            model.cap_lim = m.getfloat("CAP_LIM", model.cap_lim)
            if "MAX_Z_INT" in m:
                model.max_z_int = float(m.get("MAX_Z_INT"))
            model.latcp = m.getfloat("LATCP", model.latcp)
            model.loncp = m.getfloat("LONCP", model.loncp)
            model.eps = m.getfloat("EPS", model.eps)
            if "LATRANGE" in m:
                model.latrange = _parse_float_list(m.get("LATRANGE"))
            if "LONRANGE" in m:
                model.lonrange = _parse_float_list(m.get("LONRANGE"))
            if "ALTRANGE" in m:
                model.altrange = _parse_float_list(m.get("ALTRANGE"))
            model.numgridpnt = m.getint("NUMGRIDPNT", model.numgridpnt)

        val = ValidateConfig()
        if cp.has_section("VALIDATE"):
            v = cp["VALIDATE"]
            if "STARTTIME" in v:
                val.starttime = dt.datetime.strptime(
                    v.get("STARTTIME"), "%Y-%m-%dT%H:%M:%S"
                )
            if "ENDTIME" in v:
                val.endtime = dt.datetime.strptime(
                    v.get("ENDTIME"), "%Y-%m-%dT%H:%M:%S"
                )
            if "ALTITUDES" in v:
                val.altitudes = _parse_float_list(v.get("ALTITUDES"))
            if "COLORLIM" in v:
                val.colorlim = _parse_float_list(v.get("COLORLIM"))
            val.outpngname = v.get("OUTPNGNAME", val.outpngname)

        tpu = TPUConfig()
        if cp.has_section("TPU"):
            t = cp["TPU"]
            tpu.basis_impl = t.get("BASIS_IMPL", tpu.basis_impl)
            tpu.quad_mode = t.get("QUAD_MODE", tpu.quad_mode)
            tpu.table_domain_factor = t.getfloat(
                "TABLE_DOMAIN_FACTOR", tpu.table_domain_factor
            )
            tpu.table_tol = t.getfloat("TABLE_TOL", tpu.table_tol)
            tpu.grid_eval_impl = t.get("GRID_EVAL_IMPL", tpu.grid_eval_impl)
            tpu.regparam_mode = t.get("REGPARAM_MODE", tpu.regparam_mode)
            tpu.mesh_records = t.getint("MESH_RECORDS", tpu.mesh_records)
            tpu.mesh_points = t.getint("MESH_POINTS", tpu.mesh_points)
            tpu.chunk_size = t.getint("CHUNK_SIZE", tpu.chunk_size)
            tpu.point_bucket = t.getint("POINT_BUCKET", tpu.point_bucket)

        return cls(fit=fit, model=model, validate=val, tpu=tpu,
                   raw_text=text, path=path)
