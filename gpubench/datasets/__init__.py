"""Sources of a cell's objects and sinograms, one module per source, named by a
configuration file's ``dataset``: a function ``make(cfg, seed, device)`` that
returns (sinograms (n, angles, bins) float32 on the host, theta (angles,))."""
