"""Configuration for the diffusion framework.

Parameter names deliberately mirror the reference's ``parameters.yaml``
(ref: /root/reference/parameters.yaml:1-32) so existing configs are portable.
Derived feature sizes reproduce the arithmetic of ``main.py:102-121`` in the
reference: the node feature vector fed to the EGNN is

    h = [atom_onehot(A) | spectrum(S or S_c) | exO(1) | t/T(1)]

giving ``h_size = atom_type_size + (compressed_)spectrum_size + exO_size +
t_size`` and MLP input sizes ``m_input = 2*h_size + d_size``,
``h_input = h_size + m_size``, ``x_input = 2*h_size + d_size``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence


@dataclasses.dataclass(frozen=True)
class Config:
    # --- EGNN architecture (ref parameters.yaml:1,13,15,16,31-32) ---
    L: int = 5
    m_size: int = 256
    m_hidden_size: int = 1024
    h_hidden_size: int = 1024
    x_hidden_size: int = 1024
    x_size: int = 3
    d_size: int = 1

    # --- feature layout (ref parameters.yaml:2,4,11,27-29) ---
    atom_type_size: int = 2
    spectrum_size: int = 200
    compressed_spectrum_size: int = 32
    compressor_hidden_dim: Sequence[int] = (150, 100, 50)
    to_compress_spectrum: bool = True
    conditional: bool = True
    give_exO: bool = True
    exO_size: int = 1
    t_size: int = 1
    onehot_scaling_factor: float = 1.0

    # --- diffusion process (ref parameters.yaml:18-21) ---
    num_diffusion_timestep: int = 1000
    noise_schedule: str = "predefined"  # "predefined" | "learned"
    noise_precision: float = 1e-5
    noise_schedule_power: float = 2.0
    gamma_init: str = "reference"
    # learned-schedule gamma init: "reference" = the VDM default (-5, 10)
    # endpoints (ref SNR.py:36-37); "polynomial" = pre-fit the gamma net
    # to this config's polynomial schedule in alpha^2 space before
    # training — measurably better final quality (0.861/0.928 vs
    # 0.829/0.900 rdf_cos, docs/quality/learned_origin_test.json).
    # VDM boundary terms for the learned schedule (train/trainer.py): the
    # plain eps-MSE never samples the endpoints, so nothing stops gamma_0
    # from settling at a sigma(0) ~ 0.1 noise floor that the t=0 sampling
    # epilogue then injects into every final coordinate. Weight 0 disables
    # (reference-faithful but quality-degraded); rec floor = the position
    # discretisation scale the reconstruction likelihood saturates at.
    gamma_boundary_weight: float = 1.0
    gamma_rec_floor: float = 0.01

    # --- training (ref parameters.yaml:3,14,17,22,24-26,30) ---
    batch_size: int = 1
    lr: float = 1e-5
    weight_decay: float = 1e-12
    max_grad_norm: float = 100.0
    optimizer: str = "RAdamScheduleFree"  # "Adam" | "AdamW" | "RAdamScheduleFree"
    ema_decay: float = 0.0
    # exponential moving average of the post-update parameters, used for
    # evaluation/sampling when > 0 (standard DDPM/EDM practice the
    # reference lacks — its schedule-free optimizer's built-in averaging
    # plays the same role, so EMA is only valid with Adam/AdamW; the
    # trainer rejects the RAdamScheduleFree+EMA combination). Typical
    # values 0.999-0.9999. 0.0 = off (reference-exact).
    num_epochs: int = 3000
    patience: int = 5000
    seed: int = 2024
    checkpoint_every: int = 0
    # save a full checkpoint (params + optimizer state + epoch) every N
    # epochs for preemption-safe resume; 0 = only at the end. The reference
    # has no mid-training resume at all (SURVEY.md §5).

    # --- model variants ---
    diffuse_species: bool = True
    # True  = joint (x, h) diffusion (ref diffusion_x_h.py via main.py)
    # False = position-only diffusion with clean species features
    #         (ref E3diffusion_new.py via train.py/test.py)
    kabsch_loss: bool = False
    # adds loss_coords: full reverse diffusion inside the train step scored
    # by Kabsch RMSD against ground truth (ref train_2024_11.py:204-237)
    kabsch_loss_steps: int = 0   # 0 = use num_diffusion_timestep
    kabsch_loss_weight: float = 1.0
    spectrum_to_latent: bool = False
    # Encoder/Decoder conditioning path (ref main.py:97-98,155-166; the
    # reference's spectrum_to_latent module was never committed — this is
    # the documented extension point, see nn/spectrum_latent.py)
    latent_dim: int = 32

    # --- sampling ---
    cond_dropout_prob: float = 0.0
    # classifier-free guidance training: per-graph probability of zeroing
    # the spectrum conditioning so the model also learns the unconditional
    # score. Enables guidance_scale > 0 at sampling.
    guidance_scale: float = 0.0
    # w > 0 blends eps = (1+w)*eps_cond - w*eps_uncond (two denoiser calls
    # per step). 0 = plain conditional sampling (reference behaviour).
    sample_noise_scale: float = 1.0
    # sampling temperature: multiplies the posterior std of the noise
    # injected by every ancestral reverse step AND the t=0 epilogue.
    # 1.0 = the exact reference chain; < 1 trades sample diversity for
    # sharper distributions (a zero-training-cost lever against the
    # measured final-step jitter that blurs bond peaks on large cells,
    # docs/quality/size512net_per_t_profile.json); 0.0 coincides with
    # deterministic_sampling.
    deterministic_sampling: bool = False
    # DDIM-style eta=0 reverse process: the ancestral step's noise term is
    # dropped (mu only), making generation a deterministic function of the
    # initial noise + conditioning. Composes with sample_steps.
    sample_steps: int = 0
    # 0 = full num_diffusion_timestep reverse steps (reference behaviour).
    # K > 0 = strided ancestral sampling over K steps: the schedule table is
    # subsampled on round(linspace(0, T, K+1)) and the same posterior math
    # applies between consecutive entries (alpha_ts = alpha_t/alpha_s holds
    # for any s < t); the time feature fed to the denoiser keeps the
    # original t/T values so conditioning matches training.
    sample_grid: str = "uniform"
    # grid for strided sampling: "uniform" = round(linspace) over t;
    # "snr" = equispaced in gamma = log(sigma^2/alpha^2), concentrating
    # steps where the schedule actually moves — matters for learned
    # schedules that squeeze their signal band into a sub-interval of t.
    gen_num_per_spectrum: int = 5  # ref parts/train_per_iretation.py:264
    max_nan_retries: int = 10      # ref parts/train_per_iretation.py:379-389
    snapshot_every: int = 100      # ref parts/train_per_iretation.py:336-337

    # --- accelerator-layout knobs (new; no reference equivalent) ---
    n_max: int = 16                 # padded node count per graph
    neighbor_k: int = 0
    # 0 = dense fully-connected graphs (reference topology); K > 0 = padded
    # fixed-degree K-nearest-neighbour lists, the large-cell (1024+ atoms)
    # topology where N^2 edges explode (SURVEY.md §7). kNN is recomputed
    # from current positions each denoiser call.
    compute_dtype: str = "float32"  # "float32" | "bfloat16" for matmuls
    compat_scalar_norm: bool = False
    # ``compat_scalar_norm`` reproduces the reference's coordinate-update
    # divisor quirk: ``torch.norm(coords_i - coords_j)`` *without* dim= — a
    # single Frobenius norm over the whole edge batch rather than per-edge
    # (ref EquivariantGraphNeuralNetwork.py:64). Default False = correct
    # per-edge norm (the published EGNN formulation).
    zero_init_x: bool = True
    # zero-init the final coordinate-MLP layer so the untrained net is the
    # identity on positions (standard diffusion practice; the reference
    # instead survives early-training NaNs via its runtime retry loop).
    h_init_scale: float = 1.0
    # variance multiplier for the EGCL node-MLP output kernel at init
    # (nn/egnn.py EGCL.h_init_scale). The reference's non-residual h
    # update makes untrained feature magnitude grow ~0.2*K per layer (K =
    # neighbours), which at 512-atom kNN-32 produces repeated first-step
    # NaN epochs. ~1/K^2 (e.g. 1e-3 at K=32) holds the init-time scale
    # flat; 1.0 is the reference-equivalent lecun init. Trained model
    # family is unchanged — this only moves the starting point.
    x_parameterization: str = "eps"
    # what the denoiser's coordinate head MEANS (train + sample agree via
    # diffusion/process.x0_out_to_eps):
    #   "eps" — the network output IS the noise prediction (reference-exact,
    #           ref parts/train_per_iretation.py:161-166).
    #   "x0"  — the output is a displacement toward the CLEAN structure,
    #           x0_hat = z_t + out; converted to
    #           eps_hat = (z_t - alpha_t x0_hat)/sigma_t at every consumer,
    #           so the loss (eps-space MSE = SNR-weighted x0 error) and the
    #           sampler math are unchanged — only the network's
    #           conditioning moves. Candidate mechanism for the large-cell
    #           mid-t structure-formation deficit (docs/ROADMAP.md round-5
    #           state): at mid/high noise predicting the structure directly
    #           is better conditioned than predicting the noise.
    #   "v"   — velocity prediction v = alpha_t eps - sigma_t x0 (Salimans
    #           & Ho 2022, progressive-distillation paper; public
    #           technique), converted via eps_hat = alpha_t out +
    #           sigma_t z_t — both coefficients bounded by 1, so it keeps
    #           x0's conditioning at high noise AND eps's at low noise.
    #           Measured 192-atom CRN panels (size192_r5_lever_sweep.json):
    #           "x0" sharpens the first shell (bond width 0.195 vs 0.279,
    #           CN(Si) 3.16 vs 2.79) but loses mid-range excess RDF.
    #           The h (species) channel stays eps-parameterised in every
    #           mode.
    t_bias_frac: float = 0.0
    t_bias_lo: int = 100
    t_bias_hi: int = 600
    # timestep importance sampling (train/loss.py diffuse_batch): draw
    # this fraction of each batch's per-graph timesteps uniformly from
    # [t_bias_lo, t_bias_hi] instead of [1, T]. Motivated by the per-t
    # loss profile of large-cell runs (the chemical-order deficit sits in
    # the mid-noise structure-formation band, docs/quality/
    # size512net_per_t_profile.json). 0.0 = reference-exact uniform.
    t_loss_weight: float = 1.0
    # per-timestep LOSS weighting (train/loss.py t_band_weights): graphs
    # whose drawn t falls in [t_bias_lo, t_bias_hi] have their per-graph
    # loss multiplied by this factor, normalised by the analytic expected
    # weight so the loss scale (and the effective lr under the
    # always-clipping regime) is unchanged. Unlike t_bias_frac this keeps
    # the reference's uniform t coverage — every band still receives
    # samples; only the gradient emphasis moves. The VERDICT-r4 candidate
    # mechanism for the 512-atom structure-formation underfit
    # (docs/quality/size512net_per_t_profile.json: eps-MSE deficit at
    # t ~ 150-600). 1.0 = reference-exact unweighted loss.
    h_residual: bool = False
    # opt-in residual node update ``h' = h + mlp_h([h | sum m])`` on layers
    # whose input/output widths match (all but the first — layer 0 maps the
    # assembled feature width to h_size). The reference update is
    # NON-residual (ref EquivariantGraphNeuralNetwork.py:68-69), which is
    # the root cause of the large-cell h-magnitude blowup
    # (benchmarks/probe_network_nan.py): a single optimizer step of
    # effective size lr*max_grad_norm ~ 0.02 re-ignites ~0.2*K-per-layer
    # growth. The residual form is the standard conditioning fix; default
    # False preserves exact reference parity.
    virtual_node: bool = False
    # per-layer global-context channel (virtual node at the masked CoM,
    # pooled-feature message exchange + radial equivariant coordinate
    # update; see nn/egnn.py EGCL.virtual_node). The mid-range-order fix
    # for kNN topologies where the receptive field is ~L local hops.
    # Zero-init output heads: enabling it leaves the untrained net
    # bit-identical to the plain one. Off = reference-exact.
    global_radius_feature: bool = False
    # append log1p(|x - CoM|) to every node's input features (an E(3)-
    # invariant global-envelope signal). With kNN edges a node's receptive
    # field is purely local, so the score cannot shape the GLOBAL density
    # envelope of a large cell (mid-range order) — nodes at the box edge
    # and centre look locally identical; this scalar breaks that
    # degeneracy at O(N) cost. Off by default (the reference's dense
    # topology is global already).
    edge_rbf: int = 0
    # number of Gaussian radial-basis features of the edge DISTANCE added
    # to both edge-MLP pre-activations (nn/egnn.py EGCL.edge_rbf). The
    # reference's edge geometry input is the single squared-distance
    # scalar (ref EquivariantGraphNeuralNetwork.py:55-58) — a smooth
    # monotone feature with poor resolution at the ~0.1 A scale where the
    # Si-O bond peak lives; the measured 512-atom deficit is a 2x-broad
    # bond peak and low CN (docs/quality/size512net_per_t_profile.json).
    # K Gaussians at linspace(0, edge_rbf_rmax, K) give the message MLPs
    # a sharp local code of the distance. Both injection kernels are
    # ZERO-initialised, so enabling the flag leaves the untrained network
    # bit-identical to the plain one. 0 = reference-exact.
    edge_rbf_rmax: float = 8.0
    ring_sample: bool = False
    # route SAMPLING through the ppermute ring (parallel/ring.py
    # ring_sampler_denoise_fn): one dense-topology graph whose node axis
    # is sharded over the mesh — the generation path for cells whose
    # [N, N] pair grid exceeds one chip's HBM (SURVEY.md §2.6; the
    # capability analogue of ref generate_amorphous.py at 4096+ atoms).
    # Requires batch entries of ONE graph per sampling call
    # (api.generate_ring drives this) and neighbor_k == 0 (the ring is
    # the dense-topology scale-out; kNN cells scale on one card instead).
    # The sampler skips building the [B, N, N]
    # pair mask entirely — the ring computes pair blocks on the fly.
    remat_egcl: bool = False
    # rematerialise each EGCL layer (jax.checkpoint) so the backward pass
    # recomputes layer activations instead of holding all L layers live.
    # At 512-atom kNN-32 batch-32 training the per-layer edge-MLP hidden
    # activations are ~1 GiB each ([B,N,K,m_hidden] bf16), so the full
    # 5-layer stack plus backward holds many GiB; remat caps the live
    # set at ~one layer for ~33% extra forward FLOPs. Numerically
    # identical — parity-tested in tests/test_egnn.py.
    debug_nans: bool = False        # jax.debug analogue of torch anomaly mode
    mesh_shape: Sequence[int] = ()  # empty = single device
    mesh_axis_names: Sequence[str] = ("data",)

    # ------------------------------------------------------------------
    # Derived sizes (ref main.py:102-121)
    # ------------------------------------------------------------------
    @property
    def cond_spectrum_size(self) -> int:
        if not self.conditional:
            return 0
        if self.spectrum_to_latent:
            # ref main.py:97-98: spectrum_size becomes the latent dim
            # (mutually exclusive with compression, ref main.py:52)
            assert not self.to_compress_spectrum
            return self.latent_dim
        return (
            self.compressed_spectrum_size
            if self.to_compress_spectrum
            else self.spectrum_size
        )

    @property
    def h_size(self) -> int:
        size = self.atom_type_size + self.cond_spectrum_size + self.t_size
        if self.give_exO:
            size += self.exO_size
        if self.global_radius_feature:
            size += 1
        return size

    @property
    def m_input_size(self) -> int:
        return 2 * self.h_size + self.d_size

    @property
    def m_output_size(self) -> int:
        return self.m_size

    @property
    def h_input_size(self) -> int:
        return self.h_size + self.m_size

    @property
    def h_output_size(self) -> int:
        return self.h_size

    @property
    def x_input_size(self) -> int:
        return 2 * self.h_size + self.d_size

    @property
    def x_output_size(self) -> int:
        return 1

    def replace(self, **kwargs: Any) -> "Config":
        return dataclasses.replace(self, **kwargs)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_FIELD_NAMES = {f.name for f in dataclasses.fields(Config)}


def from_dict(d: dict) -> Config:
    """Build a Config from a dict, ignoring unknown keys (e.g. wandb extras)."""
    known = {k: v for k, v in d.items() if k in _FIELD_NAMES}
    for key in ("compressor_hidden_dim", "mesh_shape", "mesh_axis_names"):
        if key in known and isinstance(known[key], list):
            known[key] = tuple(known[key])
    return Config(**known)


def load_config(path: str) -> Config:
    """Load a reference-style parameters.yaml into a Config."""
    import yaml  # only config files need PyYAML; nothing else imports it

    with open(path) as f:
        raw = yaml.safe_load(f)
    return from_dict(raw)
