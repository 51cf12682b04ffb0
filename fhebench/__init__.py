"""fhebench: the benchmark of gpufhe_tpu_torch on one H100 (see README.md)."""
