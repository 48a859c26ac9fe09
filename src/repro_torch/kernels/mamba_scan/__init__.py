from repro_torch.kernels.mamba_scan.ops import (mamba_scan, mamba_scan_bwd,
                                                mamba_scan_with_state)
from repro_torch.kernels.mamba_scan.ref import (CHUNK, mamba_scan_bwd_ref,
                                                mamba_scan_ref,
                                                mamba_scan_with_state_ref,
                                                scan_states_ref)

__all__ = ["CHUNK", "mamba_scan", "mamba_scan_bwd", "mamba_scan_bwd_ref",
           "mamba_scan_ref", "mamba_scan_with_state",
           "mamba_scan_with_state_ref", "scan_states_ref"]
