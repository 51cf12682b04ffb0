"""primitives layer of gpufhe_tpu_torch (see the package docstring)."""
