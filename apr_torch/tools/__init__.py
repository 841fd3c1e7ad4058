"""Offline tools of the port: ``python -m apr_torch.tools.prepare_icp_cache``
(the odometry-pose ICP cache) and ``python -m apr_torch.tools.cal_overlap``
(fragment overlap ratios), the counterparts of the root
``tools/prepare_icp_cache.py`` and ``tools/cal_overlap.py``."""
