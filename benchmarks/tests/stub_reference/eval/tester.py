from reference.aprref.eval.tester import FeatureTester  # noqa: F401
