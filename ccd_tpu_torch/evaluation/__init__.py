from ccd_tpu_torch.evaluation.editdistance import levenshtein
from ccd_tpu_torch.evaluation.accuracy import TextAccuracy

__all__ = ["levenshtein", "TextAccuracy"]
