"""Host-side utilities of the port (the names of ``apr_tpu.utils``)."""

from apr_torch.utils.timer import AverageMeter, MinTimer, Timer

__all__ = ["Timer", "AverageMeter", "MinTimer"]
