"""Triangle setup, clipping, binning, visibility and shading ops."""
