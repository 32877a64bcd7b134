"""A configuration file as the port runs it, and its weights made from
the seed.

The weights are the benchmark's inputs: drawn here on the device, one
leaf at a time from a generator of its own (so any leaf can be drawn
again alone), and handed as one tree to the port and, after the window,
to the plain reference. The tree has the layout the port's entry points
take: per-layer weights stacked on a leading [n_layers] axis, matmul
weights [in, out], an int8 leaf as ``{'q': int8, 's': f32 scales}``
(per output channel; the embedding table per row)."""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

NORMS = ('attn_norm', 'mlp_norm', 'final_norm')
# The std of a uniform integer in [-127, 127].
INT8_UNIFORM_STD = 73.6116


def is_moe(config: Dict[str, Any]) -> bool:
    return 'num_local_experts' in config


def dims(config: Dict[str, Any]) -> Dict[str, int]:
    """The widths a configuration file states, under short names."""
    d = config['hidden_size']
    heads = config['num_attention_heads']
    return {'d': d, 'layers': config['num_hidden_layers'], 'heads': heads,
            'kv_heads': config['num_key_value_heads'],
            'head_dim': config.get('head_dim') or d // heads,
            'ffn': config['intermediate_size'],
            'vocab': config['vocab_size'],
            'experts': config.get('num_local_experts', 0),
            'top_k': config.get('num_experts_per_tok', 0)}


def shapes(config: Dict[str, Any]) -> Dict[str, Any]:
    """The weight tree as shapes."""
    m = dims(config)
    nl, d, hd, e = m['layers'], m['d'], m['head_dim'], m['experts']
    layers = {
        'attn_norm': (nl, d),
        'wq': (nl, d, m['heads'] * hd),
        'wk': (nl, d, m['kv_heads'] * hd),
        'wv': (nl, d, m['kv_heads'] * hd),
        'wo': (nl, m['heads'] * hd, d),
        'mlp_norm': (nl, d),
    }
    if e:
        layers.update(router=(nl, d, e), w_gate=(nl, e, d, m['ffn']),
                      w_up=(nl, e, d, m['ffn']), w_down=(nl, e, m['ffn'], d))
    else:
        layers.update(w_gate=(nl, d, m['ffn']), w_up=(nl, d, m['ffn']),
                      w_down=(nl, m['ffn'], d))
    return {'tok_emb': (m['vocab'], d), 'layers': layers,
            'final_norm': (d,), 'lm_head': (d, m['vocab'])}


def leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) in the tree's order; a {'q', 's'} dict is a leaf."""
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) != {'q', 's'}:
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _leaf_seed(seed: int, index: int) -> int:
    return (seed * 1_000_003 + 7_919 * (index + 1)) % (1 << 63)


def quantized(config: Dict[str, Any], key: str) -> bool:
    """Whether the configuration serves leaf ``key`` as int8."""
    return (config['weights']['dtype'] == 'int8' and
            key not in NORMS and key != 'router')


def draw_leaf(torch, config: Dict[str, Any], path: Tuple[str, ...],
              shape: Tuple[int, ...], index: int, seed: int, device,
              dtype=None):
    """Leaf number ``index`` of the tree drawn from ``seed``: norms 1 +
    0.1 N(0, 1); a dense weight N(0, 1) / sqrt(fan in); an int8 one a
    uniform payload in [-127, 127] with per-channel scales of the same
    std times U(0.5, 1.5). A stacked leaf is drawn a layer at a time."""
    key = path[-1]
    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(_leaf_seed(seed, index))
    if key in NORMS:
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (1 + 0.1 * w).to(dtype)
    axis = -1 if key == 'tok_emb' else -2
    fan_in = shape[axis]
    if not quantized(config, key):
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0] if len(shape) > 2 else 1):
            part = out[i] if len(shape) > 2 else out
            part.copy_(torch.randn(part.shape, generator=gen, device=device,
                                   dtype=torch.float32) * fan_in**-0.5)
        return out
    q = torch.empty(shape, dtype=torch.int8, device=device)
    for i in range(shape[0] if len(shape) > 2 else 1):
        part = q[i] if len(shape) > 2 else q
        part.copy_(torch.randint(-127, 128, part.shape, generator=gen,
                                 device=device, dtype=torch.int8))
    s_shape = list(shape)
    del s_shape[axis]
    s = (torch.rand(s_shape, generator=gen, device=device,
                    dtype=torch.float32) + 0.5) * (fan_in**-0.5 /
                                                   INT8_UNIFORM_STD)
    return {'q': q, 's': s}


def make_weights(torch, config: Dict[str, Any], seed: int, device,
                 into: Dict[str, Any] = None) -> Dict[str, Any]:
    """The whole tree from ``seed``; with ``into`` (a tree made before)
    each leaf is copied into the old one in place, so programs captured
    on it stay valid."""
    tree = into if into is not None else {}
    for i, (path, shape) in enumerate(leaves(shapes(config))):
        leaf = draw_leaf(torch, config, path, shape, i, seed, device)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if into is None:
            node[path[-1]] = leaf
        elif isinstance(leaf, dict):
            node[path[-1]]['q'].copy_(leaf['q'])
            node[path[-1]]['s'].copy_(leaf['s'])
        else:
            node[path[-1]].copy_(leaf)
    return tree


def port_config(torch, config: Dict[str, Any], max_seq: int,
                remat: Any = True):
    """The port's config object for ``config``: every width as stated,
    bf16 parameters and compute."""
    from skypilot_tpu_torch.models import LlamaConfig, MoEConfig
    m = dims(config)
    kw = dict(vocab_size=m['vocab'], dim=m['d'], n_layers=m['layers'],
              n_heads=m['heads'], n_kv_heads=m['kv_heads'],
              ffn_dim=m['ffn'], max_seq=max_seq,
              rope_theta=float(config['rope_theta']),
              norm_eps=float(config['rms_norm_eps']),
              param_dtype=getattr(torch, config['weights']['param_dtype']),
              compute_dtype=getattr(torch, config['compute_dtype']),
              remat=remat)
    if m['head_dim'] != m['d'] // m['heads']:
        raise ValueError('the port derives head_dim as dim / n_heads')
    if is_moe(config):
        return MoEConfig(n_experts=m['experts'], top_k=m['top_k'],
                         infer_dispatch=config['engine'].get(
                             'dispatch', 'dropless'), **kw)
    return LlamaConfig(**kw)
