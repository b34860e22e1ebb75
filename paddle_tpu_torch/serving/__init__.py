"""Serving layer of the port: the paged KV cache and its allocator, the
host side of speculative decoding, grammar constraints (token DFAs),
and the SLO-aware scheduler with its policy."""
from .constraints import (ConstraintState, TokenDFA,  # noqa: F401
                          dfa_from_regex, dfa_from_sequences,
                          json_schema_dfa, json_schema_pattern_dfa)
from .paged_cache import (TRASH_PAGE, BlockAllocator, PagedKVCache,  # noqa: F401
                          PoolExhausted, PrefixCache)
from .policy import (FinishReason, PreemptionPolicy, Priority,  # noqa: F401
                     StepPlan, TokenBudgetPlanner)
from .scheduler import DEGRADED_MODES, ServingScheduler  # noqa: F401
from .speculative import (NgramProposer, Speculator, TreeDraft,  # noqa: F401
                          build_comb_tree, longest_accepted_path,
                          longest_accepted_prefix, rejection_sample_tokens,
                          tree_ancestor_matrix, tree_depths,
                          tree_rejection_sample)
