"""Offline tools of the port, the counterparts of the root ``tools/``
scripts of the same names: ``python -m apr_torch.tools.prepare_icp_cache``
(the odometry-pose ICP cache), ``cal_overlap`` (fragment overlap ratios),
and the synthetic-convergence tools ``validate_convergence`` (FCGF),
``validate_predator_convergence``, ``validate_apr_gain`` (the APR vs
baseline A/B), ``pool_apr_gain`` (pools the A/B's logs) and
``sweep_ransac`` (recall vs hypothesis count and escalation)."""
