"""Host-side storage pieces the port needs: sorted projections, the
planning half of the column encodings, the integrity envelope and the
spill tmp-file manager."""
