"""Basis-model registry.

A model provides ``basis`` taking geodetic coordinates, an ``nbasis``
attribute and an ``eval_reg_matricies`` dict (the reference's plugin
contract, models/sphharmlag.py:11-15): ``sphharmlag`` (the default, the
spherical-cap-harmonic x Laguerre basis) or ``radbasfun`` (Gaussian radial
basis functions, no regularization).
"""


def make_model(name: str, config):
    if name == "sphharmlag":
        from .sphharmlag import Model

        return Model(config)
    if name == "radbasfun":
        from .radbasfun import Model

        return Model(config)
    raise ValueError(f"unknown model {name!r}")
