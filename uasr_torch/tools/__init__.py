"""Command-line tools of the port: the stream CLI, the serving daemon, data
preparation (``prepare``), forced alignment (``align``) and the timing
tools of the kernels (``time_*``)."""
