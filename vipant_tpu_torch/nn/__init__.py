"""Layers, MetaHead stages, towers and loss heads of the port."""
