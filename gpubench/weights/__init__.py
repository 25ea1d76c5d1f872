"""Sources of a cell's weights, one module per source, named by a traffic file's ``weights``."""
