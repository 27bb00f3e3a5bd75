"""Host-side label merging (counterpart of ``pypardis_tpu/parallel``).
The collectives, the sharded fits and the occurrence merge are later
slices (ROADMAP A10-A12)."""
