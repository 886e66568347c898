from .generation import generate
from .paged_kv import AdmitPlan, PageAllocator
from .serving import ContinuousBatcher, Request

__all__ = ["generate", "AdmitPlan", "PageAllocator", "ContinuousBatcher",
           "Request"]
