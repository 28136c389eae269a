from gpx_torch.utils.pytree import pytree_dataclass, tree_replace

__all__ = ["pytree_dataclass", "tree_replace"]
