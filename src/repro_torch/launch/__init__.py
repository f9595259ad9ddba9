"""Port of ``repro.launch``: the entry points users run
(``python -m repro_torch.launch.serve``)."""
