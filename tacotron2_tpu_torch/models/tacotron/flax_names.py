"""The names of the port's Tacotron tensors in the JAX package's flax trees, both ways:
`port_name` (flax -> port) is how `convert.tacotron_state_dict` lays a flax tree out,
`flax_name` (port -> flax) is what the L2 and fine-tuning filters read. Both read the
one table below.

A port name is dotted ('postnet_convolutions.convs.1.bn.weight'), a flax path
'/'-joined ('postnet_convolutions/conv_2/bn/scale'). The module names are the same on
both sides but for the port's ModuleLists, whose entry i is flax's `<name>_<i + 1>`,
and the leaves of LEAVES. A GRU's fused tensors name the flax layers they join, in
order ('cbhg_postnet/gru_fw/ir+iz+in/kernel'). At any decoder depth the LSTMs are
'decoder.lstm_1', 'decoder.lstm_2', ... on both sides and the prenet's layers
'decoder.prenet.layers.i' <-> 'decoder/prenet/dense_{i + 1}'."""

# a port ModuleList -> the flax module name it numbers from 1
INDEXED = {'convs': 'conv', 'bank': 'bank', 'highways': 'highway', 'layers': 'dense'}
_UNINDEXED = {flax: port for port, flax in INDEXED.items()}

# port leaf -> flax leaf, the more specific first ('weight' <-> 'kernel' last)
LEAVES = (
    ('inputs_embedding.weight', 'inputs_embedding'),
    ('bn.weight', 'bn/scale'),
    ('bn.running_mean', 'bn/mean'),
    ('bn.running_var', 'bn/var'),
    ('v_a', 'attention_variable_projection'),
    ('b_a', 'attention_bias'),
    ('input.weight', 'ir+iz+in/kernel'),
    ('input.bias', 'ir+iz+in/bias'),
    ('hidden.weight', 'hr+hz+hn/kernel'),
    ('bias_hn', 'hn/bias'),
    ('weight', 'kernel'),
)

# a GRU's flax layers that the port joins into one tensor, side by side
GRU_GROUPS = (('ir', 'iz', 'in'), ('hr', 'hz', 'hn'))


def _swap_leaf(path: str, pairs) -> str:
    """`path` ('/'-joined) with its last components swapped by the first (from, to) pair
    of '/'-joined leaves that ends it."""
    for old, new in pairs:
        if path == old or path.endswith('/' + old):
            return path[:len(path) - len(old)] + new
    return path


def flax_name(port_name: str) -> str:
    """The flax path of the port tensor `port_name`, e.g.
    'postnet_convolutions.convs.1.bn.weight' -> 'postnet_convolutions/conv_2/bn/scale'."""
    parts, out = port_name.split('.'), []
    i = 0
    while i < len(parts):
        if parts[i] in INDEXED and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f'{INDEXED[parts[i]]}_{int(parts[i + 1]) + 1}')
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return _swap_leaf('/'.join(out),
                      [(p.replace('.', '/'), f) for p, f in LEAVES])


def port_name(flax_path: str) -> str:
    """The port tensor of the flax path `flax_path` (a GRU's joined layers as
    GRU_GROUPS writes them), e.g. 'decoder/prenet/dense_1/kernel' ->
    'decoder.prenet.layers.0.weight'."""
    path = _swap_leaf(flax_path, [(f, p.replace('.', '/')) for p, f in LEAVES])
    out = []
    for part in path.split('/'):
        name, _, n = part.rpartition('_')
        if name in _UNINDEXED and n.isdigit():
            out += [_UNINDEXED[name], str(int(n) - 1)]
        else:
            out.append(part)
    return '.'.join(out)
