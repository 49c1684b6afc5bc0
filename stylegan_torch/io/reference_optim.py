"""The reference's torch Adam state (``GAN_{GEN,DIS}_OPTIM_*.pth``) into the
port's optimizers (the port's copy of
``stylegan_tpu/convert/torch_optim.py``).

The reference resumes runs from torch ``optimizer.state_dict()`` archives
(reference train.py:40-48, GAN.py:810-816), keyed by *parameter index*:

  {"state": {i: {"step", "exp_avg", "exp_avg_sq"}, ...},
   "param_groups": [{"params": [0..N-1], ...}]}

where index i is the i-th entry of the reference module's ``parameters()``,
its attribute-registration order.  That order is not the port's: the
reference registers D's label embeddings first and from_rgb last
(embeddings, blocks, final_block, from_rgb; GAN.py:369-379) where the port
registers blocks, from_rgb, final_block, embeddings, and G's class embedding
first where the port registers it last.  ``Adam.load_state_dict`` would give
moments to the wrong tensors without an error, so each index is mapped to a
reference *name* in the reference's order (`generator_param_order`,
`discriminator_param_order`), and the name to the port's parameter, whose
layout is the reference's.  Each parameter keeps its own step, as torch
does; the hyperparameters of the file's param_groups are not taken (the
config's are).
"""

from __future__ import annotations

import torch
from torch import nn


def _wb(prefix: str) -> list:
    return [f"{prefix}.weight", f"{prefix}.bias"]


def _epilogue(prefix: str) -> list:
    return [f"{prefix}.top_epi.noise.weight", f"{prefix}.style_mod.lin.weight",
            f"{prefix}.style_mod.lin.bias"]


def _existing(module: nn.Module, names: list) -> list:
    """`names` that are parameters of `module`, all of them listed."""
    params = dict(module.named_parameters())
    out = [n for n in names if n in params]
    leftover = sorted(set(params) - set(out))
    if leftover:
        raise ValueError(f"parameters without a reference index: {leftover}")
    return out


def generator_param_order(generator: nn.Module) -> list:
    """The reference Generator's ``parameters()`` order (GAN.py:235-252):
    the class embedding, then g_mapping's dense layers, then g_synthesis as
    its modules nest (init_block, blocks, to_rgb; weight before bias, the
    noise weight before the style's dense)."""
    syn = generator.g_synthesis
    ib = "g_synthesis.init_block"
    names = ["class_embedding.weight"]
    for i in range(len(generator.g_mapping.map)):
        names += _wb(f"g_mapping.map.dense{i}")
    names += ([f"{ib}.const", f"{ib}.bias"] + _wb(f"{ib}.dense")
              + _epilogue(f"{ib}.epi1") + _wb(f"{ib}.conv")
              + _epilogue(f"{ib}.epi2"))
    for i in range(len(syn.blocks)):
        b = f"g_synthesis.blocks.{i}"
        names += (_wb(f"{b}.conv0_up") + _epilogue(f"{b}.epi1")
                  + _wb(f"{b}.conv1") + _epilogue(f"{b}.epi2"))
    for i in range(len(syn.to_rgb)):
        names += _wb(f"g_synthesis.to_rgb.{i}")
    return _existing(generator, names)


def discriminator_param_order(discriminator: nn.Module) -> list:
    """The reference Discriminator's ``parameters()`` order (GAN.py:369-379):
    embeddings, blocks, final_block, from_rgb."""
    names = [f"embeddings.{i}.weight"
             for i in range(len(getattr(discriminator, "embeddings", ())))]
    for i in range(len(discriminator.blocks)):
        names += _wb(f"blocks.{i}.conv0") + _wb(f"blocks.{i}.conv1_down")
    names += (_wb("final_block.conv") + _wb("final_block.dense0")
              + _wb("final_block.dense1"))
    for i in range(len(discriminator.from_rgb)):
        names += _wb(f"from_rgb.{i}")
    return _existing(discriminator, names)


def load_adam_state(optimizer: torch.optim.Optimizer, module: nn.Module,
                    optim_sd: dict):
    """Set `optimizer`'s state for `module` (the port's Generator or
    Discriminator) from a reference Adam ``state_dict``.  A parameter the
    file holds no state for (torch creates it at the first step) is left
    without state, as torch would leave it."""
    order = (generator_param_order(module) if hasattr(module, "g_synthesis")
             else discriminator_param_order(module))
    state = optim_sd["state"]
    groups = optim_sd.get("param_groups", [])
    indices = (list(groups[0]["params"]) if groups
               else sorted(state, key=int))
    if len(indices) != len(order):
        raise ValueError(
            f"the torch optimizer has {len(indices)} parameters, the "
            f"reference network registers {len(order)}: wrong file or "
            "architecture mismatch")
    params = dict(module.named_parameters())
    for idx, name in zip(indices, order):
        st = state.get(idx, state.get(str(idx)))
        if st is None:
            continue
        p = params[name]
        if tuple(st["exp_avg"].shape) != tuple(p.shape):
            raise ValueError(f"moment shape mismatch for {name}: "
                             f"{tuple(st['exp_avg'].shape)} vs "
                             f"{tuple(p.shape)}")
        optimizer.state[p] = {
            "step": torch.tensor(float(st["step"]), dtype=torch.float32),
            "exp_avg": st["exp_avg"].to(p).clone(),
            "exp_avg_sq": st["exp_avg_sq"].to(p).clone()}


def load_adam_state_file(optimizer: torch.optim.Optimizer, module: nn.Module,
                         path: str):
    """Load a reference GAN_*_OPTIM_*.pth into `optimizer`."""
    load_adam_state(optimizer, module,
                    torch.load(path, map_location="cpu", weights_only=True))
