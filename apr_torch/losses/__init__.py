"""Training losses of the FCGF and Predator paths (port of
``apr_tpu/losses``)."""
