"""Eval entry points of a training run: ``python -m
apr_torch.scripts.test_apr`` and ``python -m apr_torch.scripts.test_fcgf``
(the counterparts of the root ``scripts/test_apr.py`` and
``scripts/test_fcgf.py``), and the paper-recipe launchers
``{train,test}_{apr,fcgf}_{kitti,nuscenes}.sh`` (the root ``scripts/``
launchers' counterparts, calling the port's entry points)."""
