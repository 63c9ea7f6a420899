"""Model code of the port (``repro.models`` counterpart): the dense
transformer the serve path runs."""
