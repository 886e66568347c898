from .generation import generate, sample_filter
from .paged_kv import AdmitPlan, PageAllocator
from .serving import SLO_CLASSES, ContinuousBatcher, Request

__all__ = ["generate", "sample_filter", "AdmitPlan", "PageAllocator",
           "ContinuousBatcher", "Request", "SLO_CLASSES"]
