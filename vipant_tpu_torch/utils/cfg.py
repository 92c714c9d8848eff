"""What the entry points accept as a configuration."""

from __future__ import annotations

from ..config import Config, compose


def as_config(cfg) -> Config:
    """A composed :class:`..config.Config` as it is; a list of override
    strings composed; a config object of another package with the same
    interface (``to_dict``) rebuilt as the port's own class."""
    if isinstance(cfg, Config):
        return cfg
    if hasattr(cfg, "to_dict"):
        return Config(cfg.to_dict(resolve=False))
    return compose(list(cfg))
