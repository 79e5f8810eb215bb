"""Basis-model registry.

A model provides ``basis`` taking geodetic coordinates, an ``nbasis``
attribute and an ``eval_reg_matricies`` dict (the reference's plugin
contract, models/sphharmlag.py:11-15).  Only the sphharmlag model is
ported so far.
"""


def make_model(name: str, config):
    if name == "sphharmlag":
        from .sphharmlag import Model

        return Model(config)
    if name == "radbasfun":
        raise NotImplementedError(
            "the radbasfun model is not ported to the PyTorch package yet "
            "(ROADMAP queue 1: radbasfun and series)")
    raise ValueError(f"unknown model {name!r}")
