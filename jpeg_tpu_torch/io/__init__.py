"""Container I/O: JFIF markers and BMP."""
