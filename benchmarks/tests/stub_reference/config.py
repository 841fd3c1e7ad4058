from reference.aprref.config import APRConfig  # noqa: F401
