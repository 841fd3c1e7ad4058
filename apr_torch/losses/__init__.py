"""Training losses of the FCGF path (port of ``apr_tpu/losses``)."""
