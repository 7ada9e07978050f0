"""The model zoo on PyTorch (port of ``repro.models``): the dense decoder
(``attn``/``local`` blocks) runs on the card through K5 on prefill and K4
on every decode step."""
