"""Basis-model registry.

A model provides ``basis`` taking geodetic coordinates, an ``nbasis``
attribute and an ``eval_reg_matricies`` dict (the reference's plugin
contract, models/sphharmlag.py:11-15): ``sphharmlag`` (the default, the
spherical-cap-harmonic x Laguerre basis) or ``radbasfun`` (Gaussian radial
basis functions, no regularization).
"""

import importlib

MODELS = ("sphharmlag", "radbasfun")


def get_model_module(name: str):
    """The module of model ``name`` in this package (the JAX package's
    plugin lookup, models/__init__.py:14-15); an unknown name raises."""
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}")
    return importlib.import_module("." + name, package=__name__)


def make_model(name: str, config):
    if name == "sphharmlag":
        from .sphharmlag import Model

        return Model(config)
    if name == "radbasfun":
        from .radbasfun import Model

        return Model(config)
    raise ValueError(f"unknown model {name!r}")
