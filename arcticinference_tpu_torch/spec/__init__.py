"""Speculative decoding sources of the port: the suffix tree and cache."""

from arcticinference_tpu_torch.spec.suffix_cache import (SuffixCache,
                                                         SuffixSpecResult)
from arcticinference_tpu_torch.spec.suffix_tree import (Candidate,
                                                        SuffixTree)

__all__ = ["Candidate", "SuffixCache", "SuffixSpecResult", "SuffixTree"]
