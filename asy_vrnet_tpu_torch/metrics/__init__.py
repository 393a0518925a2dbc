"""Detection and segmentation metrics (pure numpy)."""
