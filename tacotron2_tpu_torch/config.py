"""Typed configuration system: the port's copy of `tacotron2_tpu/config.py`.

The port imports nothing of the JAX package, so it keeps this pure-Python copy of the
reference's flat parameter surface (reference: hparams.py:5-374): the same `Hparams`
fields and values, the same ``--hparams 'k=v,k2=v2'`` parsing, and the same profiles
(``paper_hparams()`` mirrors reference paper_hparams.py). `tests/test_torch_paper.py`
holds the copy to the original field by field. Some field comments speak of the
TPU: they are the JAX package's, kept so the two files stay comparable.
"""

from __future__ import annotations

import ast
import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


def _sentences_default() -> List[str]:
    # Default eval corpus (reference: hparams.py:342-367).
    return [
        'Scientists at the CERN laboratory say they have discovered a new particle.',
        "There's a way to measure the acute emotional intelligence that has never gone out of style.",
        'President Trump met with other leaders at the Group of 20 conference.',
        "The Senate's bill to repeal and replace the Affordable Care Act is now imperiled.",
        'Generative adversarial network or variational auto-encoder.',
        'Basilar membrane and otolaryngology are not auto-correlations.',
        'He has read the whole thing.',
        'He reads books.',
        'He thought it was time to present the present.',
        'Thisss isrealy awhsome.',
        'The big brown fox jumps over the lazy dog.',
        'Did the big brown fox jump over the lazy dog?',
        'Peter Piper picked a peck of pickled peppers. How many pickled peppers did Peter Piper pick?',
        "She sells sea-shells on the sea-shore. The shells she sells are sea-shells I'm sure.",
        'Tajima Airport serves Toyooka.',
        'Thank you so much for your support!',
    ]


@dataclass(eq=False)  # eq=False keeps identity hashing so Hparams can be a jit static arg
class Hparams:
    """Flat hyperparameter set; field names match the reference one-to-one.

    Reference: hparams.py:5-374. TPU-specific additions are grouped at the bottom and
    replace GPU-count knobs (the reference's ``tacotron_num_gpus``/``wavenet_num_gpus``
    tower splitting, hparams.py:36-38) with a device-mesh description.
    """

    # --- text ---
    cleaners: str = 'english_cleaners'

    # --- hardware (reference: hparams.py:36-39; kept for CLI parity, the TPU path
    # uses `mesh_*` below instead of tower counts) ---
    tacotron_num_gpus: int = 1
    wavenet_num_gpus: int = 1
    split_on_cpu: bool = True

    # --- audio (reference: hparams.py:63-116) ---
    num_mels: int = 80
    num_freq: int = 1025
    rescale: bool = True
    rescaling_max: float = 0.999
    clip_mels_length: bool = True
    max_mel_frames: int = 900
    use_lws: bool = False
    silence_threshold: int = 2
    n_fft: int = 2048
    hop_size: Optional[int] = 275
    win_size: Optional[int] = 1100
    sample_rate: int = 22050
    frame_shift_ms: Optional[float] = None
    magnitude_power: float = 2.0
    trim_silence: bool = True
    trim_fft_size: int = 2048
    trim_hop_size: int = 512
    trim_top_db: float = 40
    signal_normalization: bool = True
    allow_clipping_in_normalization: bool = True
    symmetric_mels: bool = True
    max_abs_value: float = 4.0
    normalize_for_wavenet: bool = True
    clip_for_wavenet: bool = True
    wavenet_pad_sides: int = 1
    preemphasize: bool = True
    preemphasis: float = 0.97
    min_level_db: float = -100
    ref_level_db: float = 20
    fmin: float = 55
    fmax: float = 7600
    power: float = 1.5
    griffin_lim_iters: int = 60
    GL_on_GPU: bool = True  # on-device (jit) Griffin-Lim instead of host numpy

    # --- tacotron model (reference: hparams.py:121-175) ---
    outputs_per_step: int = 1
    stop_at_any: bool = True
    batch_norm_position: str = 'after'
    clip_outputs: bool = True
    lower_bound_decay: float = 0.1
    embedding_dim: int = 512
    enc_conv_num_layers: int = 3
    enc_conv_kernel_size: Tuple[int, ...] = (5,)
    enc_conv_channels: int = 512
    encoder_lstm_units: int = 256
    smoothing: bool = False
    attention_dim: int = 128
    attention_filters: int = 32
    attention_kernel: Tuple[int, ...] = (31,)
    cumulative_weights: bool = True
    synthesis_constraint: bool = False
    synthesis_constraint_type: str = 'window'
    attention_win_size: int = 7
    prenet_layers: Tuple[int, ...] = (256, 256)
    decoder_layers: int = 2
    decoder_lstm_units: int = 1024
    max_iters: int = 10000
    postnet_num_layers: int = 5
    postnet_kernel_size: Tuple[int, ...] = (5,)
    postnet_channels: int = 512
    cbhg_kernels: int = 8
    cbhg_conv_channels: int = 128
    cbhg_pool_size: int = 2
    cbhg_projection: int = 256
    cbhg_projection_kernel_size: int = 3
    cbhg_highwaynet_layers: int = 4
    cbhg_highway_units: int = 128
    cbhg_rnn_units: int = 128
    mask_encoder: bool = True
    mask_decoder: bool = False
    cross_entropy_pos_weight: float = 1.0
    predict_linear: bool = True

    # --- wavenet model (reference: hparams.py:187-233) ---
    input_type: str = 'raw'
    quantize_channels: int = 2 ** 16
    use_bias: bool = True
    legacy: bool = True
    residual_legacy: bool = True
    log_scale_min: float = float(math.log(1e-14))
    log_scale_min_gauss: float = float(math.log(1e-7))
    cdf_loss: bool = False
    out_channels: int = 2
    layers: int = 20
    stacks: int = 2
    residual_channels: int = 128
    gate_channels: int = 256
    skip_out_channels: int = 128
    kernel_size: int = 3
    cin_channels: int = 80
    upsample_type: str = 'SubPixel'
    upsample_activation: str = 'Relu'
    upsample_scales: Tuple[int, ...] = (11, 25)
    freq_axis_kernel_size: int = 3
    leaky_alpha: float = 0.4
    NN_init: bool = True
    NN_scaler: float = 0.3
    gin_channels: int = -1
    use_speaker_embedding: bool = True
    n_speakers: int = 5
    speakers_path: Optional[str] = None
    speakers: Tuple[str, ...] = ('speaker0', 'speaker1', 'speaker2', 'speaker3', 'speaker4')

    # --- tacotron training (reference: hparams.py:238-290) ---
    tacotron_random_seed: int = 5339
    tacotron_data_random_state: int = 1234
    tacotron_swap_with_cpu: bool = False
    tacotron_batch_size: int = 32
    tacotron_synthesis_batch_size: int = 1
    tacotron_test_size: Optional[float] = 0.05
    tacotron_test_batches: Optional[int] = None
    tacotron_decay_learning_rate: bool = True
    tacotron_start_decay: int = 40000
    tacotron_decay_steps: int = 18000
    tacotron_decay_rate: float = 0.5
    tacotron_initial_learning_rate: float = 1e-3
    tacotron_final_learning_rate: float = 1e-4
    tacotron_adam_beta1: float = 0.9
    tacotron_adam_beta2: float = 0.999
    tacotron_adam_epsilon: float = 1e-6
    tacotron_reg_weight: float = 1e-6
    tacotron_scale_regularization: bool = False
    tacotron_zoneout_rate: float = 0.1
    tacotron_dropout_rate: float = 0.5
    tacotron_clip_gradients: bool = True
    tacotron_natural_eval: bool = False
    tacotron_teacher_forcing_mode: str = 'constant'
    tacotron_teacher_forcing_ratio: float = 1.0
    tacotron_teacher_forcing_init_ratio: float = 1.0
    tacotron_teacher_forcing_final_ratio: Optional[float] = 0.0
    tacotron_teacher_forcing_start_decay: int = 10000
    tacotron_teacher_forcing_decay_steps: int = 40000
    tacotron_teacher_forcing_decay_alpha: Optional[float] = None
    tacotron_fine_tuning: bool = False

    # --- wavenet training (reference: hparams.py:294-337) ---
    wavenet_random_seed: int = 5339
    wavenet_data_random_state: int = 1234
    wavenet_swap_with_cpu: bool = False
    wavenet_batch_size: int = 8
    wavenet_synthesis_batch_size: int = 20
    wavenet_test_size: Optional[float] = None
    wavenet_test_batches: Optional[int] = 1
    wavenet_lr_schedule: str = 'exponential'
    wavenet_learning_rate: float = 1e-3
    wavenet_warmup: float = 4000.0
    wavenet_decay_rate: float = 0.5
    wavenet_decay_steps: int = 200000
    wavenet_adam_beta1: float = 0.9
    wavenet_adam_beta2: float = 0.999
    wavenet_adam_epsilon: float = 1e-6
    wavenet_clip_gradients: bool = True
    wavenet_ema_decay: float = 0.9999
    wavenet_weight_normalization: bool = False
    wavenet_init_scale: float = 1.0
    wavenet_dropout: float = 0.05
    # rematerialize residual blocks in the train backward pass (TPU analog of the
    # reference's wavenet_swap_with_cpu host offload, wavenet.py:895): trades
    # recompute FLOPs (cheap — the step is HBM-bound) for activation traffic
    wavenet_remat: bool = False
    wavenet_gradient_max_norm: float = 100.0
    wavenet_gradient_max_value: float = 5.0
    max_time_sec: Optional[float] = None
    max_time_steps: Optional[int] = 11000
    wavenet_natural_eval: bool = False
    train_with_GTA: bool = True

    # --- eval / debug (reference: hparams.py:342-372) ---
    sentences: List[str] = field(default_factory=_sentences_default)
    wavenet_synth_debug: bool = False
    wavenet_debug_wavs: Tuple[str, ...] = ('training_data/audio/audio-LJ001-0008.npy',)
    wavenet_debug_mels: Tuple[str, ...] = ('training_data/mels/mel-LJ001-0008.npy',)

    # --- TPU-native additions (no reference analog; replaces §2.9/§2.10 tower DP) ---
    mesh_data_axis: int = -1          # -1 = use all available devices on the data axis
    mesh_model_axis: int = 1          # model-parallel axis size (WaveNet channel sharding)
    mesh_num_slices: int = 0          # multi-slice: 0 = auto-detect from device slice_index;
                                      # >1 forces a slice-major (DCN-aware) mesh layout —
                                      # data-parallel traffic crosses slices over DCN, the
                                      # model axis stays inside one slice's ICI
    compute_dtype: str = 'bfloat16'   # activations dtype on TPU ('float32' to disable)
    transfer_dtype: str = 'float32'   # host->device wire dtype for float batch arrays
                                      # ('float16' halves feed bandwidth; targets are
                                      # promoted back to f32 arithmetic on device)
    params_dtype: str = 'float32'
    remat_decoder: bool = False       # jax.checkpoint the Tacotron decoder scan body
    data_prefetch: int = 2            # device prefetch depth for the input pipeline
    bucket_group_batches: int = 64    # feeder bucketing group size (reference feeder.py:159 `_batches_per_group`)
    decoder_scan_unroll: int = 4      # steps unrolled per decoder scan iteration (7% faster train step)
    decoder_chunk_size: int = 64      # synthesis early-exit granularity (decoder steps per while_loop chunk)
    fused_decoder: bool = True        # custom-VJP decoder scan for train/eval/GTA (ops/fused_decoder.py)
    wavenet_fused_ar: bool = True     # AR kernel: fold residual 1x1s into next layer's gates (1 serial matmul/layer)
    pad_text_multiple: int = 16       # round text length up: bounds XLA shape count
    pad_mel_multiple: int = 64        # round mel length up: bounds XLA shape count

    # ------------------------------------------------------------------
    def validate(self) -> None:
        """Cross-field checks (reference: tacotron.py:42-53, wavenet models/__init__.py:6-9)."""
        if self.input_type not in ('raw', 'mulaw', 'mulaw-quantize'):
            raise ValueError(f'unknown input_type: {self.input_type}')
        if self.input_type == 'mulaw-quantize':
            if self.out_channels != self.quantize_channels:
                raise ValueError('out_channels must equal quantize_channels for mulaw-quantize input')
        else:
            if self.out_channels != 2 and self.out_channels % 3 != 0:
                raise ValueError('out_channels must be 2 (Gaussian) or a multiple of 3 (MoL)')
        if self.upsample_type not in ('1D', '2D', 'Resize', 'SubPixel', 'NearestNeighbor'):
            raise ValueError(f'unknown upsample_type: {self.upsample_type}')
        prod = 1
        for s in self.upsample_scales:
            prod *= s
        if self.cin_channels > 0 and prod != self.get_hop_size():
            raise ValueError(f'prod(upsample_scales)={prod} != hop_size={self.get_hop_size()}')
        if self.synthesis_constraint_type not in ('window', 'monotonic'):
            raise ValueError(f'unknown synthesis_constraint_type: {self.synthesis_constraint_type}')
        if self.batch_norm_position not in ('before', 'after'):
            raise ValueError(f'unknown batch_norm_position: {self.batch_norm_position}')
        if self.tacotron_teacher_forcing_mode not in ('constant', 'scheduled'):
            raise ValueError(f'unknown teacher forcing mode: {self.tacotron_teacher_forcing_mode}')
        if self.use_lws:
            raise ValueError('use_lws is not supported: the LWS package is not part of '
                             'this framework; the librosa-convention STFT/iSTFT path '
                             'is used for both models')

    def get_hop_size(self) -> int:
        # reference: datasets/audio.py:223-228
        hop_size = self.hop_size
        if hop_size is None:
            if self.frame_shift_ms is None:
                raise ValueError('set hop_size or frame_shift_ms')
            hop_size = int(self.frame_shift_ms / 1000.0 * self.sample_rate)
        return hop_size

    def get_win_size(self) -> int:
        return self.win_size if self.win_size is not None else self.n_fft

    # ------------------------------------------------------------------
    def parse(self, override: str) -> 'Hparams':
        """Apply a comma-separated ``k=v`` override string in place (reference CLI parity,
        e.g. train.py:35). Returns self for chaining. Values are parsed with
        ``ast.literal_eval`` falling back to raw strings; booleans accept True/False."""
        if not override:
            return self
        items = _split_overrides(override)
        valid = {f.name: f for f in dataclasses.fields(self)}
        for key, raw in items:
            if key not in valid:
                raise ValueError(f'unknown hparam: {key!r}')
            setattr(self, key, _coerce(raw, getattr(self, key)))
        self.validate()
        return self

    def values(self) -> dict:
        return dataclasses.asdict(self)

    def replace(self, **kw) -> 'Hparams':
        """Return a modified (unfrozen) copy — the only mutation path once frozen."""
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # Freezing. Hparams is identity-hashed (eq=False) so it doubles as a jit /
    # lru_cache key; mutating an instance after compiled code captured it would
    # silently serve stale traces. Trainers/synthesizers call freeze() at first
    # use; after that any attribute assignment raises and replace() must be used.
    def freeze(self) -> 'Hparams':
        object.__setattr__(self, '_frozen', True)
        return self

    @property
    def frozen(self) -> bool:
        return getattr(self, '_frozen', False)

    def __setattr__(self, name: str, value: Any) -> None:
        if getattr(self, '_frozen', False):
            raise dataclasses.FrozenInstanceError(
                f'Hparams is frozen (already captured by compiled code); '
                f'use hp.replace({name}=...) to get a modified copy')
        object.__setattr__(self, name, value)


def _split_overrides(s: str) -> List[Tuple[str, str]]:
    """Split 'a=1,b=[2,3],c="x,y"' respecting brackets/quotes."""
    items: List[Tuple[str, str]] = []
    depth = 0
    quote: Optional[str] = None
    cur = ''
    for ch in s:
        if quote:
            if ch == quote:
                quote = None
            cur += ch
        elif ch in '"\'':
            quote = ch
            cur += ch
        elif ch in '([{':
            depth += 1
            cur += ch
        elif ch in ')]}':
            depth -= 1
            cur += ch
        elif ch == ',' and depth == 0:
            if cur.strip():
                items.append(_kv(cur))
            cur = ''
        else:
            cur += ch
    if cur.strip():
        items.append(_kv(cur))
    return items


def _kv(s: str) -> Tuple[str, str]:
    if '=' not in s:
        raise ValueError(f'bad hparam override (expected k=v): {s!r}')
    k, v = s.split('=', 1)
    return k.strip(), v.strip()


def _coerce(raw: str, current: Any) -> Any:
    low = raw.lower()
    if low in ('true', 'false'):
        return low == 'true'
    if low in ('none', 'null'):
        return None
    try:
        val = ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw
    if isinstance(current, tuple) and isinstance(val, list):
        return tuple(val)
    if isinstance(current, bool):
        return bool(val)
    if isinstance(current, float) and isinstance(val, int):
        return float(val)
    return val


def default_hparams() -> Hparams:
    return Hparams()


def paper_hparams() -> Hparams:
    """Exact-paper profile (reference: paper_hparams.py — deltas per SURVEY §C2)."""
    hp = Hparams(
        max_mel_frames=1000,
        trim_top_db=45,
        preemphasize=False,
        fmin=75,
        predict_linear=False,
        clip_outputs=False,
        legacy=False,
        residual_legacy=False,
        log_scale_min_gauss=float(math.log(9.1188196e-4)),
        cdf_loss=True,
        # WaveNet: MoL with 10 mixtures, 24 layers / 4 stacks
        out_channels=30,
        layers=24,
        stacks=4,
        residual_channels=256,
        gate_channels=512,
        skip_out_channels=256,
        upsample_type='2D',
        upsample_scales=(5, 5, 11),
        NN_scaler=0.1,
        # LR / decay constants from the paper profile
        tacotron_decay_steps=24500,
        tacotron_final_learning_rate=1e-5,
        tacotron_reg_weight=1e-7,
        wavenet_learning_rate=1e-4,
    )
    return hp


def hparams_debug_string(hp: Hparams) -> str:
    """reference: hparams.py:376-379."""
    values = hp.values()
    lines = ['  %s: %s' % (name, values[name]) for name in sorted(values) if name != 'sentences']
    return 'Hyperparameters:\n' + '\n'.join(lines)
