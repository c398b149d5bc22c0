"""Shared infrastructure the port needs: table statistics (stats.py), the
statement interrupt checkpoint (interrupt.py) and the host-tax ledger the
streaming pipeline and the memory governor report to (gap_ledger.py)."""
