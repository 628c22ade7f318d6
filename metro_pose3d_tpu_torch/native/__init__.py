"""The port's host runtime: C libraries (`croprep.c`, `jpegdec.c`,
`pngdec.c`, `resize.c`) built with the machine's compiler at first use, and
the nvJPEG decoder (`nvjpegdec.cu`) built with nvcc where libjpeg is
missing, all loaded with ctypes (`build.py`)."""
