"""The port's host IO runtime: JPEG decode (libjpeg) and video decode
(libav) in C++, built lazily with ``g++`` by ``loader`` into one shared
library per source, so a machine without libav loses only video."""
