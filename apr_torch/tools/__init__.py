"""Offline tools of the port, the counterparts of the root ``tools/``
scripts of the same names: ``python -m apr_torch.tools.prepare_icp_cache``
(the odometry-pose ICP cache), ``cal_overlap`` (fragment overlap ratios),
``export_nuscenes_kitti`` (nuScenes to the KITTI-style layout), the
synthetic-convergence tools ``validate_convergence`` (FCGF),
``validate_predator_convergence``, ``validate_apr_gain`` (the APR vs
baseline A/B), ``pool_apr_gain`` (pools the A/B's logs) and
``sweep_ransac`` (recall vs hypothesis count and escalation), and the
profilers ``profile_build``, ``profile_pyramid``, ``profile_train_step``,
``profile_predator``, ``profile_predator_sustained``, ``profile_sort`` and
``probe_radius_select`` (stage splits on the card, over
``apr_torch/utils/profiling.py``)."""
