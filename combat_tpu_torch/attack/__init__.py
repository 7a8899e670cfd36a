from .triggers import additive_trigger, create_targets_bd, identity_grid, warp_trigger

__all__ = ["additive_trigger", "create_targets_bd", "identity_grid", "warp_trigger"]
