from tpubq_torch.parallel import mesh, sharded

__all__ = ["mesh", "sharded"]
