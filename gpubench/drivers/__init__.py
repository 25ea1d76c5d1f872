"""Drivers of a measured window, one module per driver, named by a traffic file's ``driver``."""
