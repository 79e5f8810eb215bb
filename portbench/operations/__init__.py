"""The operations a traffic mix drives, one module each, found by the
mix's ``op``: each defines ``Runner`` (see ``portbench.harness``)."""
