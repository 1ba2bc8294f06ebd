from pylda_tpu_torch.utils.config import LDAConfig

__all__ = ["LDAConfig"]


def round_up(x: int, m: int) -> int:
    """Round x up to the nearest multiple of m (padding/tiling helper)."""
    return ((x + m - 1) // m) * m
