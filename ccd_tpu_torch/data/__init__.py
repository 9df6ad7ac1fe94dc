from ccd_tpu_torch.data.lmdb import LmdbReader, LmdbWriter

__all__ = ["LmdbReader", "LmdbWriter"]
