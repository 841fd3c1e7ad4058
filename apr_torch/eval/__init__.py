"""Registration eval: FeatureTester (FCGF), PredatorTester and capacity
bucketing."""

from apr_torch.eval.predator_tester import PredatorTester
from apr_torch.eval.tester import FeatureTester, TestStats

__all__ = ["FeatureTester", "PredatorTester", "TestStats"]
