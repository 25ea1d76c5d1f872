"""Utilities: the flax-msgpack checkpoint reader."""
