"""Diagonal linear recurrence (the DIFF instruction)."""
