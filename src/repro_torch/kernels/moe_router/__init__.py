from repro_torch.kernels.moe_router.ops import moe_router
from repro_torch.kernels.moe_router.ref import moe_router_ref

__all__ = ["moe_router", "moe_router_ref"]
