"""Command-line tools of the port: the stream CLI and the serving daemon."""
