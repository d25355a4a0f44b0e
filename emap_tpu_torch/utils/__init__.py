"""Host-side helpers: PLY point-cloud I/O and visualization."""
