"""Utilities of the port: the ctypes bindings of the native C++ library."""
