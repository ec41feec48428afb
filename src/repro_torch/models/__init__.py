"""The model families (port of ``repro.models``): so far the recsys
family; the LM and GNN families are ROADMAP item 3."""
