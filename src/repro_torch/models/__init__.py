"""Model code of the port (``repro.models`` counterpart): the decoder the
serve path runs, in the dense, MoE and VLM families."""
