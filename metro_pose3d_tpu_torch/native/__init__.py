"""The port's host runtime in C (`croprep.c`, `jpegdec.c`), built with the
machine's compiler at first use and loaded with ctypes (`build.py`)."""
