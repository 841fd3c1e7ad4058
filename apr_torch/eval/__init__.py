"""Registration eval: FeatureTester and capacity bucketing."""

from apr_torch.eval.tester import FeatureTester, TestStats

__all__ = ["FeatureTester", "TestStats"]
