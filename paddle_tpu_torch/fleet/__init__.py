"""Fleet control plane: the SLO-driven elastic autoscaler over the serve
router (the port's copy of `paddle_tpu/fleet/`)."""
from . import autoscaler  # noqa: F401
from .autoscaler import (Action, AutoscalePolicy, AutoscalerDaemon,  # noqa: F401,E501
                         DiurnalLoadSim, PolicyState, decide,
                         fleet_view, observe, after_action)

__all__ = ["autoscaler", "Action", "AutoscalePolicy",
           "AutoscalerDaemon", "DiurnalLoadSim", "PolicyState",
           "decide", "fleet_view", "observe", "after_action"]
