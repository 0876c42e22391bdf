"""Loops that drive the program under test: set-up, the measured window
and the traced calls. Each records every call's shapes for the readers."""
