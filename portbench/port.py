"""The program under test as the benchmark reaches it: ``repro_torch``'s
public entry points and nothing else.

The harness builds the program's ``ModelConfig`` from a configuration file
(:func:`model_config`), hands it the benchmark's drawn weights under the
program's parameter names (:func:`load_model`, through
``convert.load`` and ``convert.to_serving``, the program's own serving
set-up), and drives ``launch.steps.make_prefill_step`` and
``make_decode_step`` on the kernel path.  It reads the kernels' launch
counters (each wrapper's ``fn.launches``).  Everything is imported inside
the functions, so that importing this module loads none of the program.
"""
from __future__ import annotations

from portbench.spec import Geometry

#: The benchmark's leaf names (``weights.py``) as the program names them.
LAYER_NAMES = {
    "input_layernorm": "ln1.scale",
    "q_proj.w": "attn.wq.w", "q_proj.b": "attn.wq.b",
    "k_proj.w": "attn.wk.w", "k_proj.b": "attn.wk.b",
    "v_proj.w": "attn.wv.w", "v_proj.b": "attn.wv.b",
    "o_proj.w": "attn.wo.w",
    "q_norm": "attn.q_norm.scale", "k_norm": "attn.k_norm.scale",
    "post_attention_layernorm": "ln2.scale",
    "mlp.gate_proj": "mlp.wg.w", "mlp.up_proj": "mlp.wi.w",
    "mlp.down_proj": "mlp.wo.w",
    "mlp.router": "moe.router.w", "mlp.experts.gate_proj": "moe.wg",
    "mlp.experts.up_proj": "moe.wi", "mlp.experts.down_proj": "moe.wo",
}
TOP_NAMES = {"embed_tokens": "embed", "norm": "ln_f.scale",
             "lm_head": "head.w"}

#: Kernel-name fragments of the program's own kernels, by kernel.
KERNELS = {"flash_attention": ("flash_wgmma", "flash_simt"),
           "decode_attention": ("decode_bulk", "decode_merge",
                                "decode_split")}


def import_program() -> None:
    """Import the modules the cells drive (the program's own import)."""
    import repro_torch.launch.steps  # noqa: F401
    import repro_torch.models.convert  # noqa: F401


def model_config(g: Geometry):
    """The program's ``ModelConfig`` of the configuration, kernels on."""
    from repro_torch.models.config import ModelConfig

    moe = {}
    if g.is_moe:
        moe = dict(n_experts=g.router_outputs, experts_per_token=g.top_k,
                   capacity_factor=g.capacity_factor, moe_impl="einsum")
    cfg = ModelConfig(
        name=g.name, family="moe" if g.is_moe else "dense",
        n_layers=g.n_layers, d_model=g.d_model, n_heads=g.n_heads,
        n_kv_heads=g.n_kv_heads, d_head=g.head_dim, d_ff=g.d_ff,
        vocab_size=g.vocab, block_pattern=("attn",), qkv_bias=g.qkv_bias,
        use_qk_norm=g.qk_norm, rope_theta=g.rope_theta, norm="rmsnorm",
        act="silu", glu=True, dtype="bfloat16", use_kernels=True, **moe)
    if cfg.padded_vocab != g.padded_vocab:
        raise ValueError(f"{g.name}: the program pads the vocabulary to "
                         f"{cfg.padded_vocab}, the file assumes "
                         f"{g.padded_vocab}")
    return cfg


def port_state_dict(weights: dict) -> dict:
    """The benchmark's leaves under the program's parameter names."""
    out = {}
    for name, t in weights.items():
        if name.startswith("layers."):
            _, i, leaf = name.split(".", 2)
            out[f"layers.{i}.{LAYER_NAMES[leaf]}"] = t
        else:
            out[TOP_NAMES[name]] = t
    return out


def load_model(g: Geometry, cfg, weights: dict, device):
    """The program's model holding ``weights`` (every parameter given),
    prepared for serving by the program's own ``to_serving``."""
    from repro_torch.models.convert import load, to_serving

    experts = g.held if g.is_moe else None
    return to_serving(load(cfg, port_state_dict(weights), device=device,
                           experts=experts))


def prefill_step(cfg):
    from repro_torch.launch.steps import make_prefill_step

    return make_prefill_step(cfg)


def decode_step(cfg):
    from repro_torch.launch.steps import make_decode_step

    return make_decode_step(cfg)


def init_caches(cfg, batch: int, max_len: int, device) -> list[dict]:
    from repro_torch.models.transformer import init_caches as init

    return init(cfg, batch, max_len, device=device)


def _counters() -> dict:
    from repro_torch.kernels.decode_attention import ops as DA
    from repro_torch.kernels.flash_attention import ops as FA

    return {"flash_attention": FA.flash_attention,
            "decode_attention": DA.decode_attention}


def zero_launches() -> None:
    for fn in _counters().values():
        fn.launches = 0


def launches() -> dict[str, int]:
    """Launches of each kernel since :func:`zero_launches` (on the CPU the
    wrappers run their plain versions and count nothing)."""
    return {name: fn.launches for name, fn in _counters().items()}


def build_kernels(device) -> None:
    """Compile the two kernels the cells launch, where they are missing
    (the program's build, into its directory inside the checkout)."""
    if device.type != "cuda":
        return
    from repro_torch import compat

    compat.build(["flash_attention", "decode_attention"])
