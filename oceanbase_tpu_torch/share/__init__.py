"""Shared infrastructure the port needs: table statistics (stats.py)."""
