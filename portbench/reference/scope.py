"""What the plain reference models, and the refusal of a configuration it
does not model.

Each operation states, per INI section, the keys its reference reproduces
and the values it knows (None: any value); a configuration with any other
key, or another value, is refused before the program is set up, so a cell
is never held to a reference of other semantics (a GCV search, curvature
regularization or another model checked against the chi2 / 0th-order
sphharmlag reference).
"""

INI_SECTIONS = ("DEFAULT", "MODEL", "TPU")


def refuse_unmodelled(cfg, modelled):
    """Raise ValueError naming every key of cfg's INI sections that
    ``modelled`` ({section: {key: allowed values or None}}) does not
    cover."""
    wrong = []
    for sec in INI_SECTIONS:
        known = modelled.get(sec, {})
        for key, value in cfg.get(sec, {}).items():
            if key not in known:
                wrong.append(f"[{sec}] {key} (not modelled)")
            elif known[key] is not None and str(value) not in known[key]:
                wrong.append(f"[{sec}] {key} = {value} (the reference knows "
                             f"{sorted(known[key])})")
    if wrong:
        raise ValueError("the plain reference does not model this "
                         "configuration: " + "; ".join(wrong))
