"""Variational inference: ELBO, serving state and amortized inference."""
