"""The registry of step variants the pricing sweeps (:mod:`.variants`)
and the committed memory baseline (``memory_baseline.json``)."""
