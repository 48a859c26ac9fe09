from repro_torch.kernels.lstm_cell.ops import lstm_cell
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref

__all__ = ["lstm_cell", "lstm_cell_ref"]
