"""The comparisons that decide ``correct``: the program's outputs against
the plain reference of ``benchmark.reference``, and the same numbers read
from the reference in a lower precision (the control) or with a planted
fault, for setting and testing the limits."""
