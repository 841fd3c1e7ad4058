"""Eval entry points of a training run: ``python -m
apr_torch.scripts.test_apr`` and ``python -m apr_torch.scripts.test_fcgf``
(the counterparts of the root ``scripts/test_apr.py`` and
``scripts/test_fcgf.py``)."""
