from ccd_tpu_torch.utils.device import resolve_device
from ccd_tpu_torch.utils.logging import Logger
from ccd_tpu_torch.utils.meters import Averager, MetricLogger, SmoothedValue, Timer

__all__ = ["resolve_device", "Logger", "MetricLogger", "SmoothedValue", "Averager",
           "Timer"]
