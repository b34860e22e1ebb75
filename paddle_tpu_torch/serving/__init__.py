"""Serving layer of the port: the paged KV cache and its allocator, and
the host side of speculative decoding."""
from .paged_cache import (TRASH_PAGE, BlockAllocator, PagedKVCache,  # noqa: F401
                          PoolExhausted, PrefixCache)
from .speculative import (NgramProposer, Speculator, TreeDraft,  # noqa: F401
                          build_comb_tree, longest_accepted_path,
                          longest_accepted_prefix, rejection_sample_tokens,
                          tree_ancestor_matrix, tree_depths,
                          tree_rejection_sample)
