"""Arrival kinds, one file each, found by a traffic mix's ``arrivals``:
``<kind>.py`` with ``due_times(traffic, seconds)``, the due times (s
from the window's start) of every task of an open loop, all inside
``[0, seconds)``, or None for a closed loop (one client sends its next
task when the last is answered, until the window's seconds are up)."""
