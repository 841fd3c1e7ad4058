"""Host-side utilities of the port (the names of ``apr_tpu.utils`` less
``MinTimer``, which nothing reads)."""

from apr_torch.utils.timer import AverageMeter, Timer

__all__ = ["Timer", "AverageMeter"]
