"""Serving layer of the port: the paged KV cache and its allocator, the
host side of speculative decoding, grammar constraints (token DFAs),
the SLO-aware scheduler with its policy, supervised fault recovery
(fault injection, the request journal, ``EngineSupervisor``,
drain/restore), the durable journal (``WriteAheadLog``: segmented
CRC-framed log, incremental checkpoints, ``recover_state`` for a cold
restart), the host KV tier (``HostPageStore``,
``TieredKVCache``: swap-out / swap-in, prefix demote / promote, the
standing prefix store), the multi-tenant LoRA adapter pool
(``AdapterPool``, ``AdapterRegistry``) and the serving cluster
(``ServingCluster``: supervised replicas behind the ``ClusterRouter``,
the prefill→decode handoff, failover, retirement, ``AdmissionController``
and ``ClusterAutoscaler``; the trace-driven harness ``synth_trace`` /
``run_trace`` under a ``FakeClock``)."""
from .adapters import (FACTOR_NAMES, AdapterPool,  # noqa: F401
                       AdapterPoolExhausted, AdapterRegistry, init_lora,
                       merge_lora)
from .constraints import (ConstraintState, TokenDFA,  # noqa: F401
                          dfa_from_regex, dfa_from_sequences,
                          json_schema_dfa, json_schema_pattern_dfa)
from .host_tier import HostPageStore, TieredKVCache  # noqa: F401
from .paged_cache import (TRASH_PAGE, BlockAllocator, PagedKVCache,  # noqa: F401
                          PoolExhausted, PrefixCache)
from .policy import (FinishReason, PreemptionPolicy, Priority,  # noqa: F401
                     StepPlan, TokenBudgetPlanner)
from .resilience import (CLUSTER_SITES, DEGRADED_MODES,  # noqa: F401
                         ENGINE_SITES, SITES, CorruptionDetected,
                         EngineDead, EngineSupervisor, FaultInjector,
                         InjectedFault, JournalEntry, RequestJournal,
                         StepStalled, fault_point, install,
                         load_drain_checkpoint, payload_checksums,
                         run_with_deadline, tamper_point, uninstall,
                         verify_checksums)
from .scheduler import ServingScheduler  # noqa: F401
from .wal import WriteAheadLog, recover_state  # noqa: F401
from .speculative import (NgramProposer, Speculator, TreeDraft,  # noqa: F401
                          build_comb_tree, longest_accepted_path,
                          longest_accepted_prefix, rejection_sample_tokens,
                          tree_ancestor_matrix, tree_depths,
                          tree_rejection_sample)
from .router import (AdmissionController, ClusterRouter,  # noqa: F401
                     TenantQuota)
from .cluster import ClusterAutoscaler, ServingCluster  # noqa: F401
from .traffic import (FakeClock, SLOReport, TraceRequest,  # noqa: F401
                      run_trace, synth_trace)
