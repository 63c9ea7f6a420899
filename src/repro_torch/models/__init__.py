"""Model code of the port (``repro.models`` counterpart): the decoder of
every decoder family (dense, MoE, MLA, SSD, hybrid, VLM), the
encoder-decoder, and the facade over both (``models.registry``)."""
