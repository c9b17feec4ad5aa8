"""Chip smoke test: serve the paper's SNNs (and a plastic one that learns
per session), learn on-chip, train the SHD DH-SNN, the ECG SRNN, the ALIF
feed-forward net, a banded-topology program and the BCI cross-day decoder
(with its on-chip fine-tune), and run flash attention through
`repro_torch` on one H100.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device of compute capability 9.0 and `nvcc`; it builds
the hand kernels from `src/repro_torch/csrc/` and runs these phases. Any
failure raises and the script exits non-zero; no phase catches and
continues, and nothing falls back to the CPU.

    python3 chip_smoke.py --sweep

runs the device and build phases and the serial-chain kernels' sweep
alone (see 3.), with no other phase, and

    python3 chip_smoke.py --kernels

the kernel phase and the sweep with no path, and

    python3 chip_smoke.py --path topology_banded

the device and build phases and one path (any of 4.-17.'s names, `bci`,
`serve_plastic` and `train_banded` among them) alone:
copied into an older checkout, `--kernels` or `--path` measures that
tree the same way, so two trees compare in one call.

1. device   the card, its compute capability, and its name and power limit
            as `nvidia-smi` reports them. TF32 is switched off for every
            PyTorch matmul and convolution before any comparison, so the
            plain versions run in full fp32.
2. build    `kernels/_build.py` compiles every CUDA source with its own
            `nvcc -c`, all started together, and links them with one
            `nvcc -shared`; prints the seconds and what ptxas reports of
            each kernel, and fails if the recurrent backward's warp route
            spills at N = 64 (its W rows in registers).
3. kernels  first the launch floor: `cuda_ms` of a one-element in-place
            `add_`, the least a launch costs back to back, printed on its
            own line and beside every kernel row (`floor_ms`); a call is
            held to max(bound, floor). Then each kernel against its plain
            PyTorch version on the card, at
            the shapes one serving window of each path hands it (window
            32 x 64 sessions: the SHD DH-SNN's, the ECG SRNN's with a state
            ten windows into ECG records, and the ALIF feed-forward run's
            (250, 64, 64)) and at ragged shapes (T=37, B=3, N=130, `lif`
            with both resets; `lifrec`, `alif` and `alifrec` also at N=300
            and N=1024, from nonzero v0/a0/s0, so the block route holds
            W_rec in shared memory at N=130 and reads it through L2 above;
            spikemm 1000 x 700 x 257); `lifrec` and `alifrec` on rows wider
            than a block's 1024 threads, N = 1025, 2048 and 4096, ragged
            (T=37, B=3) and in the ECG window's shape (T=32, B=64; timed at
            N=2048); both on each side of the scan's route edges, N = 1,
            31, 32, 33, 64, 127, 128, 129 and 1024 at B = 1, 3 and 64
            (T=37), at T=1 and with rows firing in most steps, each call's
            route read off `rec_route_launch_counts()` (the warp route up
            to 128 neurons, the block route above);
            `stdp_seq` at each learning rule's term planes of the
            plastic_ff path (captured from its plan.run), at the JAX
            family's ragged shape (K=2, T=12, B=4, 130 x 140), with four
            term planes, and with bounds of +-0.4 that the trajectory hits;
            at T = 1, G - 1 and G + 1 (G = STDP_SEQ_GROUP), K = 4, a window
            of T = 2000, terms that end mid-stage (K=4, B=5), B = 1,
            ragged tiles of float4 rows (260 x 100), and at B = 0 through
            the C entry point (the wrapper cannot express it);
            `stdp` at one step of the stdp_step path and at the JAX kernel
            tests' shapes (8, 256, 256), (16, 300, 200), (4, 128, 640)
            with fp32 and bf16 traces (all timed), on planes that are not
            16-byte aligned (a `pre_spikes[t]`-like slice at B = 3,
            130 x 70, and rows of N = 128 one element into their buffer;
            fp32 and bf16), and at B = 0 and B = 1;
            `linrec` also at the plastic_ff pair rule's three calls
            (captured at `plan.linrec`: the two trace scans, (300, 8, 256)
            and (300, 8, 128), and the LI readout (300, 8, 4); timed) and
            at D = 6, 20 (B = 64), 130 (B = 3) and 4097 lanes (B = 1), each
            at T = 1, 31, 33 and 300 with a stride-0 decay and with a full
            decay plane;
            `lif` also at four paths' calls (captured at `plan.lif_scan`:
            plastic_ff's pair rule (300, 8, 128), plastic_online's first
            chunk (200, 4, 128), sparse_integ at density 0.05
            (256, 8, 512), topology_banded's second streamed chunk
            (64, 1, 8192); timed, each tagged with its path), and `lif`
            (both resets) and `alif` at rows of N = 6, 20 (B = 64), 130
            (B = 3) and 4097 lanes (B = 1), each at T = 1, 15, 16, 17, 33
            and 300 from a nonzero state with lanes that fire in most
            steps, and with signed zeros at thresholds of 0 and -0.5; the
            lane scans (`linrec`, `lif`, `alif`) are held bit for bit as
            fp32 bit patterns, signs of zeros included;
            `spikemm_sparse` at the sparse_integ path's hidden INTEG
            (densities 0.05 and 0.01) and its readout INTEG ((2048 x 512)
            @ (512 x 20) at 0.01), an all-silent, an all-occupied and a
            partly graded raster at the hidden INTEG's shape, 128 x 8192
            @ 8192 x 64 (Kb = 128), 96 x 66000 @ 66000 x 24 (more k blocks
            than a CTA lists at once), `bench_kernels`' SPARSITY_SHAPE at
            four densities and two ragged shapes: each also equal to the
            dense kernel bit for bit, its occupancy kernel's flags equal
            to `block_occupancy` and its total to their sum; timed whole,
            occupancy alone and product alone beside the dense kernel;
            `spikemm_gather` at the banded path's chunk, the topology
            benchmark's exec_vs_dense (also against the dense spikemm on
            `dense_equivalent()`), scale_1e5 and scale_1e6 rows at M = 1,
            8 and 64 (scale_1e6 at M = 8 also a row at a time, each equal
            to its row of the batch), the six ragged encodings of the JAX
            tests, and edge cases at bk = bn = 8, 32, 128 and bk = 8,
            bn = 4, each at M = 1, 8, 9, 64, 65 (graded spikes of either
            sign with -0.0 entries and a silent row, patches with rows of
            -0.0 and of +0.0, post blocks made only of sentinels), on a
            raster where only the last pre neuron of each block fires, and
            on an all-silent raster (its output must be +0 everywhere);
            every gather case equal to `spikemm_gather_ref` as fp32 bit
            patterns; B6, the gather's backward (`spikemm_gather_bwd`:
            `csrc/spikemm_gather_bwd.cu` on `GatherTables.transpose()`),
            at train_banded's captured call (d_spikes of the band, (1024,
            8192)) and on the transposed tables of topology_banded's band
            and of scale_1e5 at 1024 and 64 rows of a dense graded g, each
            equal to `spikemm_gather_bwd_ref` as fp32 bit patterns and
            timed beside one CSR `torch.sparse.mm` of W, beside the route
            it replaced (the forward's event walk on the transposed tables,
            bit for bit the same), with its issue floor (two fp32 issues a
            needed term);
            the session axis of kernels 1 and 7 at serve_plastic's window
            (32 steps, 256 -> 128; S = 1, 7 and 64 sessions, each on its own
            weight, captured at plan's calls in one learning `plan.run` of
            stacked sessions; the pair rule's two term planes and the
            triplet rule's four): `spikemm_sessions` within 1e-5 of its
            plain version and bit for bit `spikemm_sessions_chain_ref`,
            `stdp_seq_sessions` bit for bit its plain version, and each
            session of both equal bit for bit to the unbatched kernel on
            its rows alone (`spikemm` on its (T, K) rows; `stdp_seq` at
            batch 1, as int32 views); `spikemm_sessions`
            (`csrc/spikemm_sessions.cu`) timed beside `torch.bmm`,
            `stdp_seq_sessions` (`csrc/stdp_sessions.cu`) beside its two
            issue floors (the plain order's 4K + 3 fp32 operations a
            weight-step and the kernel's 3K + 3, on 128 lanes an SM at
            the highest SM clock);
            `lif_bwd` (B1) and `linrec_bwd` (B2), the backward kernels:
            each model's calls of one train_shd step (captured at the
            registry, a stride-0 view kept a view; timed: the soma (60,
            48, 64), the branches (60, 48, 256) on the soma's (60, 48, 64)
            cotangent with g_a summed over T and B, and the readout (60,
            48, 20); B2 also at every other path's readout, its chain
            floor printed beside), `lif_bwd` with every
            surrogate at alpha 0.5, 1, 2 and both resets at the JAX tests'
            (37, 3, 130), and at (20, 3, 130), T = 1, T = 0 and ragged
            (17, 1, 33), (5, 3, 7), and across the segments of its lane
            backward (T = SEG - 1, SEG, SEG + 1, 2 SEG + 5 and 300 at the
            soma's 48 x 64 lanes and ragged 1 x 33, 3 x 7, 3 x 130, every
            surrogate, both resets, alpha 2), and one launch a call (a
            CUDA graph of a call holds that one kernel node and nothing
            else, read through the driver; the profiler, where its trace
            holds a device event, sees that one kernel; no PyTorch op runs
            after it);
            `lif` and `lif_bwd` (B1) also at the bci path's day-0
            training step, (50, 128, 512) at the default BCIConfig
            (captured: the forward at `snn_layers.lif_scan`, zero reset;
            the backward at the registry, the `LIF()` rectangle surrogate
            at alpha 1, need_tau=False and need_v0=False: tau and v0 are
            constants), each timed and bit for bit its plain version,
            tagged with the bci path (the kernel table's "2, bci" and
            "B1, bci" rows);
            `linrec_bwd` at (24, 3, 136), (37, 3,
            136), T = 1, T = 0 and (17, 1, 33) with a full, a stride-0
            and a (D,) decay (g_a summed), asked for every gradient, for
            g_x alone and for g_a and g_x, and at the edges of its
            segments, buffers and lane maps (`linrec_bwd_edge_cases`):
            each bit for bit its plain version as fp32 bit
            patterns (sigmoid: rtol 1e-6, atol 1e-7, its expf), and
            `linrec_bwd`'s gx also equal to the forward kernel run on the
            flipped, one-shifted decay; its timed calls one launch each,
            as `lif_bwd`'s; `spikemm_wgrad` (B3) at every g_w call
            of one step of the three training paths (train_shd's
            (700, 2880) @ (2880, 256) and (64, 2880) @ (2880, 20),
            train_ecg's (4, 3200) @ (3200, 64), the recurrent
            (64, 3200) @ (3200, 64) from s0 and the spikes plane and
            (64, 3200) @ (3200, 6), train_alif_ff's (700, 2880) @
            (2880, 64) and its readout's), timed beside `torch.matmul`
            and the route it replaced (the dense kernel on the transposed
            raster), and at the edges of its split and tiles (R = 0, 1,
            31, 33, 1000, 4097; one chunk and the most chunks; K = 1 to
            100, N = 1 to 300 across the columns-a-lane plans; a raster
            off 16-byte alignment, one shifted from a head, an all-zero
            one whose output must be +0, one firing everywhere), each
            within 1e-5 of the plain product and bit for bit
            `spikemm_wgrad_chain_ref`; then each training g_w through
            `spikemm_g_w` under `auto` and set_sync_debug_mode("error"):
            one `spikemm_wgrad` launch, no occupancy launch; the train_shd
            and train_ecg g_w products also on the route it replaced,
            `spikemm` and `spikemm_sparse` on the transposed raster,
            timed beside `torch.matmul`; train_banded's g_w products
            ((700, 1024) @ (1024, 8192), (8192, 1024) @ (1024, 20)) and
            its forward INTEGs on the channel `auto` routed ((1024, 700)
            @ (700, 8192) and (1024, 8192) @ (8192, 20)), each timed
            beside `torch.matmul`;
            `lifrec_bwd` (B4), `alifrec_bwd` and `alif_bwd` (B5): the
            train_ecg and train_alif_ff steps' calls (timed: (200, 16,
            64) under sigmoid alpha 4, (60, 48, 64)), the JAX families'
            make_inputs shapes ((20, 3, 70); (20, 3, 130), the block
            route), every surrogate at alpha 0.5, 1, 2, 4 at T = 37 from
            a nonzero v0, a0, s0, the route edges and the warp route's
            splits N = 31, 32, 33, 63, 64, 65, 96, 97, 127, 128, 129,
            1024 at B = 1, 3, 64, a block a row (B = 15, 16, 17 at
            N = 64; 301 x 64, 500 x 33, 1000 x 128) and the edges of its
            chunks (T = 2, 5, 31, 32, 33, 65 at N = 64; 16, 17 at
            N = 128), N = 240, 241 (the backward's block route
            holds W_rec in shared memory up to 240), a wide row (16, 16,
            2048) through L2 (timed), T = 1 and 0, rows firing in most
            steps, `alif_bwd` on lane rows of 6, 20, 130, 4097 at T = 1,
            15, 16, 17, 33 (beta 0.5), each call's route read off
            `rec_route_launch_counts()`, each bit for bit its plain
            version, the scratch planes' bound printed beside, and for
            `lifrec_bwd` and `alifrec_bwd` the chain floor (T x N adds
            of an assumed 4 cycles at the card's highest SM clock,
            `nvidia-smi`'s clocks.max.sm), and their cycles by pass
            at train_ecg's call, `alif_bwd`'s and `lif_bwd`'s by phase
            (load, forward, surrogate, reverse, store, the sums over B) at
            train_alif_ff's and train_shd's soma call, `linrec_bwd`'s
            (load, reverse, store, sums) at train_shd's and train_ecg's
            calls, and
            `spikemm_wgrad`'s by phase (waits, copies' issue, products,
            the cluster barrier, the combine; the steps computed) at each
            training g_w (a build of `rec_bwd.cu`, `alif_bwd.cu`,
            `lif_bwd.cu`, `spikemm_wgrad.cu` and `linrec_bwd.cu` with
            -DREC_BWD_PASS_CLOCKS, -DALIF_BWD_PASS_CLOCKS,
            -DLIF_BWD_PASS_CLOCKS, -DWGRAD_PASS_CLOCKS and
            -DLINREC_BWD_PASS_CLOCKS, made beside the
            library, bit for bit the library's outputs);
            `spikemm` also at the parity harness's inputs, at the
            sparse_integ path's hidden INTEG at each density and at the
            topology_banded path's readout INTEG (64 x 8192 @ 8192 x 8);
            no output may be all zero. The time kernels and the learning
            kernels and the gather must match bit for bit; `spikemm`
            within rtol = atol = 1e-5 of the plain matmul (the fp32 sum
            order differs; the banded readout, |out| ~ 800, at rtol 1e-4)
            and bit for bit `spikemm_chain_ref`, the kernel's ascending-k
            chain; the sparse channel within 1e-4 (its `KernelSpec.tol`),
            with bit equality reported. Times each with
            CUDA events after warm-up: the kernel, its plain version and,
            where one exists, a PyTorch call of the same function as a
            yardstick (`library_ms`: `torch.matmul`, or `torch.sparse.mm`
            on a CSR matrix where the dense one does not fit).
            Then the gather's rows a warp x columns a lane: each timed
            gather case of 8 rows or more under every instantiation of
            `csrc/spikemm_gather.cu`, bit for bit the wrapper's, timed
            beside the plan's pick (`phase_gather_rows`). Then the sparse
            channel's host syncs: it runs with and without flags under
            `torch.cuda.set_sync_debug_mode("error")`, and one `auto`
            dispatch gives exactly one sync warning under "warn", on a
            raster routed sparse and on one routed dense
            (`sparse_sync_checks`); and its product at every tile of
            `SPARSE_TILES` on each timed case, bit for bit the wrapper's,
            timed beside `sparse_tile`'s pick (`phase_sparse_tiles`).
            Then the sweep of the serial-chain kernels: the plastic_ff pair
            rule's `stdp_seq` planes, its pre-trace `linrec` call and its
            `lif` call cut to T = 1, 75, 150 and 300 steps, alif_ff's
            `alif` call to T = 1, 64, 128 and 250, the ECG windows'
            `alifrec` and `lifrec` calls to T = 1, 8 and 32, the
            train_ecg step's `alifrec_bwd` and `lifrec_bwd` calls to
            T = 1, 50, 100 and 200, each bit for bit (the backward's
            sigmoid within its tolerance) and timed; the fit ms = a + b T
            splits a call into its launch and prologue (a) and a step (b).
4. paths    each path served through the engine, with every launch counter
            set to 0 just before its run and read just after:
            * shd: `make_dhsnn_shd` at 700 -> 64 (x4 branches) -> 20, 128
              sessions of SHD-like rasters (96..152 steps);
            * shd_homogeneous: its LIF ablation, 32 sessions of
              Bernoulli(0.2) rasters (it is almost silent on SHD-like
              input), untimed;
            * ecg: `make_srnn_ecg` at 4 -> 64 self-recurrent ALIF -> 6 LI,
              128 sessions of `gen_ecg_qtdb` records, 1301 steps each;
            * ecg_homogeneous: its recurrent-LIF ablation, 32 sessions.
            Weights from torch.Generator seed 0, EngineConfig(window=32,
            capacity=64), ragged chunks 17/23/31/40 arriving over rounds.
            Checks for each:
            * every launch counter grew by launches-per-window x windows,
              and the other kernels' (the sparse and gather ones among
              them) stayed at 0; every recurrent-scan launch on the route
              its hidden width plans (the ECG SRNN's 64: the warp route);
            * the engine's outputs equal a one-shot `plan.run` of all
              sessions on the card bit for bit (cohorts, windows, packing,
              the recurrence carried through state["out"] and the state
              cache change nothing);
            * the card against the CPU (plain versions, same weights):
              hidden spike trains under the threshold-tie rule (a lane may
              differ only from a step where the CPU reference's pre-reset
              membrane lies within 1e-5 of its threshold, computed here in
              float64; row-wise for the self-recurrent layers, where a
              flipped lane reaches the whole row through W_rec), readouts
              within 1e-4 before each session's first divergence, for
              `plan.run` and for the engine; the hidden layer must fire in
              at least 1 % of its lane-steps, and the final states of the
              rows that never diverged agree within 1e-4 (rtol and atol);
            * one session solo against packed: bit-identical on the card.
            Latency and sessions/s pool REPLAYS timed replays of the trace
            (fresh engines); the launch counts come from the first.
5. alif_ff  `benchmarks/bench_snn_engine.py`'s `shd_alif_ff` program
            (700 -> 64 ALIF(beta=0.5) -> 20 LI(tau=0.97)) through one
            `plan.run` of Bernoulli(0.2) input at T=250, B=64: the launch
            counters (`alif` among them), and the card against the CPU
            under the per-lane tie rule with the 1 % floor.
6. topology_banded
            `benchmarks/bench_topology_exec.py`'s program: 8192 LIF(0.8,
            0.6) fed through `Connection("input", topology=enc)`, `enc` the
            sparse_coo band of +-64 at weight 0.05, read out by 8 LI(0.9)
            at 0.1; `plan.run_stream` over T=2048 in chunks of 64 at batch
            1 on Bernoulli(0.2) input: 32 `spikemm_gather` launches;
            streamed outputs and final state equal one-shot `plan.run` bit
            for bit; the card against the CPU under the tie rule, with no
            lane flipped at a tie (the gather and `lif` are bit for bit
            their plain versions; the readout, |v| ~ 8000, within 1e-4 +
            1e-4 x |v|); peak device
            memory of the T=2048 stream at most 1.25x the T=256 stream's
            (`max_memory_allocated`), one-shot T=2048 printed beside it.
7. sparse_integ
            `bench_snn_engine.run_sparsity_rows`: the homogeneous DH-SNN at
            4096 -> 512 -> 20, one eager `plan.run` (T=256, B=8) per
            population-packed density 0.01, 0.05, 0.2, 0.5 under `auto`:
            each INTEG's occupancy at the sparse kernel's block and the
            channel its launch counters show (sparse at or below 0.25),
            and one occupancy launch an INTEG (`auto` measures once and
            hands the flags on);
            `always` and `never` equal `auto` bit for bit; the card against
            the CPU under the tie rule at every density, where a density
            whose hidden layer fires under the 1 % floor is reported as not
            counting, and at least one density routed sparse must count.
8. plastic_ff
            `bench_plasticity.measure_program`'s program, `make_plastic_ff`
            at 256 -> 128 -> 4, one learning plan.run at T=300, B=8 of
            Bernoulli(0.15) per built-in rule (pair, triplet, reward with a
            (T,) uniform reward, accumulated-spike with a teaching signal
            on the last step): the plan lowers each to `stdp_seq`, one
            launch per run; params are not written; the forward against
            the CPU under the tie rule with the 1 % floor; the learned
            weight and traces against the CPU's `synapse_run` fed with the
            card's own spike trains, within 1e-4; REPRO_SNN_ENGINE=stepper
            learns the same weight within 1e-5 (or, where its spikes flip
            at threshold ties, its own trains' synapse_run within 1e-4);
            `learn=False` launches no `stdp_seq` and changes no output.
9. plastic_online
            `examples/stdp_online.py`'s loop at the bench widths: 6 chunks
            (T=200, B=4) of two alternating input assemblies, chunked
            (`apply_learned` between chunks; each chunk must change the
            weight) and streamed (`run_stream`, learning from the carried
            synapse state while the forward reads the entry params): 12
            `stdp_seq` launches, every learned state against a CPU
            `synapse_run` replay on the card's trains within 1e-4, the
            streamed outputs equal to one frozen plan.run over the stream.
10. stdp_step
            `bench_plasticity.measure_rule_only`'s shapes through the legacy
            `stdp_run(use_kernel=True)` at T=300, B=8, 256 x 128: 300 `stdp`
            launches; the weight equals `use_kernel=False` on the card and
            the CPU's plain version within 1e-5 (the JAX test's tolerance).
10a. serve_plastic
            `EngineConfig(window=32, capacity=64, learn=True)` serving
            `make_plastic_ff` at 256 -> 128 -> 4 with pair STDP (the
            plastic_ff widths), 128 sessions of Bernoulli(0.15) input in
            ragged chunks (96..152 steps each), every session learning on
            its own weight: per window one `spikemm_sessions` (the plastic
            INTEG) and one `stdp_seq_sessions`, a `spikemm` (the readout),
            a `lif` and three `linrec` (the readout and two traces);
            params never written; every window's hidden trains held to the
            CPU engine's session by session under the threshold-tie rule
            (the CPU's float64 membrane from its entry membrane and entry
            weight), readouts within 1e-4 before a session's divergence,
            and every undiverged session's learned weight and traces
            within 1e-4 of the CPU's; the hidden layer at or over the 1 %
            floor; one session solo equal bit for bit to itself in the
            full cohort, its learned synapses included; p50/p99 window
            latency, sessions/s, card ms a window by kernel.
10b. resilience
            runtime robustness through the main path, counters set to 0
            before each part. The served SHD DH-SNN (64 sessions of
            gen_shd_spikes, window 32, capacity 64) under
            `faults.inject("drop_blocks:p=0.2,seed=1;dead_rows:frac=0.1,
            seed=2;bitflip:frac=1e-3,seed=3")` with guard sanitize, then
            warn: the clean path's launches a window; every session's
            hidden train against the CPU engine's under the tie rule (the
            float64 membrane of the perturbed input and weights), readouts
            within 1e-4 before a session's divergence; the guard incident
            lists equal to the CPU's, in order. guard=off with no fault:
            the clean launches, a window's dispatched ops those of the
            clean window (`host_ops`), no host sync (warn one, sanitize
            none; `set_sync_debug_mode`). Host ms a window (p50, mean) and
            card ms by kernel with no fault and under the faults with guard
            off, warn and sanitize. serve_plastic's model (64 sessions,
            learn=True) under `nan_weights:frac=0.2` with sanitize: finite
            weights and outputs, learned weights within 1e-4 of the CPU's,
            the CPU's incidents; one window of 64 sessions with
            `GuardConfig(w_ratio_max=)` put between two sessions'
            learned-norm ratios: sanitize rolls back exactly the sessions
            above it (entry weights bit for bit) and keeps the others' bit
            for bit, warn flags exactly those, and so does the CPU. A
            plastic_ff stream of 6 `plan.run` windows (T=300, B=8)
            snapshotted by `StreamCheckpointer` after the first 3, restored
            into zero templates and finished: params and state equal the
            uninterrupted card run bit for bit.
11. train_shd
            `examples/shd_dhsnn_torch.py`'s training at the published
            widths: the DH-SNN (700 -> 64 x 4 -> 20) and its LIF ablation,
            5 clipped-SGD steps at lr 0.2 on gen_shd_spikes(48, T=60)
            through `plan.run`, forward and backward, counters set to 0
            just before: per step spikemm x2 (the INTEGs; dense or
            sparse as `auto` routes, one occupancy launch each and none
            for a g_w), spikemm_wgrad x2 (g_w), lif, lif_bwd, and a
            linrec and a
            linrec_bwd for the readout and (dendritic) the branches; every
            loss finite and printed; the first step against the CPU's
            (loss within 1e-4 relative, each gradient leaf within a
            relative L2 error of 1e-3), the forward's hidden trains under
            the tie rule, lane-steps at a surrogate window edge counted;
            the first step again under `auto`, `never` and `always`, the
            channel of every spikemm call printed (g_w must take
            `spikemm_wgrad` under auto and never and the sparse channel
            under always) and each within the same tolerances of the counted
            run (bit equality printed); the step's ms by host clock (median
            of 5 after 2 warm-ups) and the card's by kernel (profiler,
            printed); the dendritic step's branch call is its one
            linrec_bwd: no PyTorch fill, copy, add or sum of the
            branches' planes in a step (profiler with record_shapes:
            `branch_call_ops`, named on a line of their own), and
            hidden/neuron/w_tau_d, summed by that kernel, within a
            relative L2 error of 1e-4 of the CPU's.
12. train_ecg
            `examples/ecg_srnn_torch.py`'s training at the published
            widths: `make_srnn_ecg` 4 -> 64 self-recurrent ALIF -> 6 LI
            (sigmoid surrogate, alpha 4) and its recurrent-LIF ablation,
            5 clipped-SGD steps at lr 0.1 on gen_ecg_qtdb(16, T=200),
            per-timestep cross-entropy, through `plan.run`: per step
            spikemm x2 (INTEG), spikemm_wgrad x3 (g_w: input,
            recurrent, readout),
            alifrec (lifrec) and its backward, linrec and linrec_bwd,
            every recurrent launch on the warp route; the gates of 11.,
            the hidden trains row-wise, the training firing rate printed
            beside the 1 % floor.
13. train_alif_ff
            the ALIF feed-forward program of 5. (700 -> 64 ALIF -> 20 LI)
            trained as 11. trains: per step spikemm x2, spikemm_wgrad
            x2, alif, alif_bwd,
            linrec, linrec_bwd; the gates of 11.
13a. train_banded
            topology_banded's band (8192 LIF(0.8, 0.6) behind a +-64 band at
            0.05) with a trainable dense layer in front (700 -> 8192
            LIF(0.8, 0.6), w_input at 2 / sqrt(700): at 1 / sqrt(700) the
            front fires under the floor and the band not at all; PERF.md)
            and 20 LI(0.9) read out through w_hidden; 5 clipped-SGD steps
            at lr 0.2 of the cross-entropy of the summed readout on
            gen_shd_spikes(16, T=64): per step spikemm x2, spikemm_gather
            (the forward), spikemm_gather_bwd (B6), lif x2, lif_bwd x2,
            linrec, linrec_bwd, spikemm_wgrad x2; the gates of 11., and
            the forward: the front layer's trains under the tie rule, the
            band layer's in the rows where the front never diverged (its
            membrane from the CPU's front spikes through the band's
            tables), both layers at or over the 1 % floor.
14. bci    `examples/bci_onchip_torch.py`'s decoder at the default
            BCIConfig, the paper's widths (128 channels x 50 bins of
            20 ms, 16 paths x 32, kernel_t 5, 4 classes), weights from
            torch.Generator seed 2, counters set to 0 just before:
            TRAIN_STEPS clipped-SGD steps at lr 0.05 on
            gen_bci_trials(128, day=0) (per step one `lif` and one
            `lif_bwd`), then on each of days 1-3 the accuracy on 64 test
            trials before and after `bci_finetune_fc`'s 25 steps at lr
            0.05 on 32 trials (one `lif` a forward, no `lif_bwd`: the
            features need no gradient); no other kernel launches. Gates:
            every loss finite; the first training step against the CPU's
            (loss within 1e-4 relative, each gradient leaf within a
            relative L2 error of 1e-3); the day-0 spike record of the
            first step's weights against the CPU's under the threshold-tie
            rule (the float64 membrane of the CPU's own features), logits
            within 1e-4 on every trial with no flipped lane, and the LIF
            layer firing in at least 1 % of its lane-steps; the first
            fine-tune day whose 32-trial record has no lane flipped at a
            tie (every day's record is held to the tie rule) fine-tuned on
            the CPU from the card's trained weights, its 25 losses, fc_w
            and fc_b within a relative L2 error of 1e-4 of the card's.
            Prints the accuracies (not gated: five steps on synthetic data
            say nothing of accuracy), the firing rate, the step's ms by
            host clock (median of 5 after 2 warm-ups), the card's by
            kernel (profiler) and the simulated TaiBai power and
            efficiency of the fine-tuned decoder's test records
            (`core/simulator.py` on `bench_applications.bci_task`'s layer
            statistics: a behavioural model of the paper's chip and its
            RTX 3090 comparator, not a measurement of this card).
15. attention
            `kernels.attention.ops.flash_attention` through the registry,
            once per case, counters set to 0 just before: the JAX kernel
            tests' grid (BH=4: (256, 256, 64), (512, 512, 128), (384, 640,
            64) x causal, window 128, non-causal at T = S) and their bf16
            case; `_make_inputs`' (2, 160, 64); d = 1, 16, 32, 96, 256;
            rows with no allowed key; the padded-key shape (2, 256, 160,
            64); `bench_kernels`' (4, 1024, 64); one prompt of
            prefill_32k at qwen2-1.5b's widths (BH=12, d=128, its 2 KV heads
            repeated) and at zamba2-1.2b's shared block with a 4096 window
            (BH=32, d=64), both bf16; BH=17, T=128, S=2^20, d=128 bf16,
            whose last heads' K/V start past element 2^31; and bf16 twins
            at d = 64 and 128 of the ragged and edge shapes (T != S, a
            window, non-causal with and without a window, no allowed key,
            padded keys, T not a multiple of 128), and a split at d = 64.
            Each call's route comes from `plan_call`: bf16 at d = 64 or 128
            on the tensor cores (one launch, two with a split over KV: the
            kernel and its combine), the rest on the CUDA cores (one). The
            route counters must show each case's planned launches (int64 a
            split), the registry's counter their sum, and every other
            counter 0. Each output
            against the plain version on the card (a few heads a call where
            the score plane is large): fp32 within rtol = atol = 2e-4 (the
            JAX test's), bf16 within one bf16 spacing (rtol 2^-7, atol 1e-2
            of the reference's RMS); every head within a relative norm of
            1e-2 and none all zero. Times the kernel, its plain version and
            `scaled_dot_product_attention` (its fused backends only; a
            yardstick) at make_inputs, bench and the three full-width cases.
            Then `_FlashST`'s straight-through VJP at T=256, S=160, d=64,
            causal with window 128 (the parity phase holds (2, 160, 64))
            against autograd through the plain version, within 2e-3.
16. verifier  the compile-time verifier (`repro_torch.analysis`) on the
            card, also alone as `--path verifier`; in the whole script it
            runs right after the build, while the process's profiler
            sessions still record every kernel. (a) The CLI gate
            `analysis --all --fail-on warning` in this process: no finding
            at warning or above; counts and wall time printed. (b) The
            served SHD DH-SNN (64 sessions, window 32) under
            REPRO_CHECK=raise against REPRO_CHECK=off: outputs bit for bit,
            the same launches a window (spikemm 2, linrec 2, lif 1), the
            same PyTorch ops and host syncs over the run; compile_program's
            host ms under both for each path's program and the p50 window
            under both printed; the reference test's TB231 weight collision
            raises `DiagnosticError` at compile time with no launch. (c)
            Each registered family's tile model against the card's own
            launches, at `make_inputs`' call, every candidate route and the
            paths' shapes: one call captured in a CUDA graph, each kernel
            node's grid, block and dynamic shared memory read through the
            driver (with the kernel's static shared memory,
            `cuFuncGetAttribute`), and the same call traced by
            torch.profiler, whose Kineto events give grid, block and
            shared memory where the trace carries them (the two must
            agree). The model's grid and threads must equal the launch's,
            its shared memory bound the launch's (TB304) within 8x (TB305),
            and the launch's fit the card's opt-in budget. (d) TB307 on the
            flags `occupancy_cuda` measures on sparse_integ's rasters at
            densities 0.01, 0.05 and 0.5.
17. parity  `repro_torch.kernels.parity.check_all()`: every family's CUDA
            wrapper and the sparse channel's against their plain versions
            at `make_inputs`, forward, and the VJP of `attention`, `lif`,
            `linrec`, `lifrec`, `alif`, `alifrec` and `spikemm` (both
            channels: CUDA forward and backward, spikemm's backward its
            `spikemm_wgrad` pair, against plain forward and backward) and
            `spikemm_gather` (its backward B6); the session axis of
            `spikemm` and `stdp_seq`; 13 kernels.
18. result  prints `{"kernels": [...]}`, `{"bwd_passes": {...}}`,
            `{"gather_rows": {...}}`,
            `{"sparse_tiles": {...}}`, `{"sweep": {...}}`, one
            `{"slice": {...}}` line per path, `{"parity": {...}}`, the
            card's name and power limit and, last, `{"ok": true,
            "device": {...}}`.

Bounds (`bound_ms`) are computed from this run's inputs against the H100
SXM's published peaks: 67 TFLOP/s fp32 (CUDA cores) and 3.35 TB/s HBM,
each input byte read once and each output byte written once. spikemm's
operations are what its product needs on this run's raster, 2 * nnz * N,
whatever tiling a kernel chooses; the sparse channel computes the same
function and counts the same 2 * nnz(s) * N; the gather's are
2 * sum over pre of nnz(s[:, pre]) * fan-out(pre), each spike adding its
neuron's nonzero weights, and its bytes are the nonzero weights those
spikes need (of every pre neuron that spikes in some row of the call),
the raster and the output; printed beside it, the read-rows bound (the
patch rows the kernel reads, bn weights each) and the every-patch bound
(see `work`); the recurrent kernels' are their
elementwise steps plus 2 * nnz(s_{t-1}) * N for the spikes that feed the
next step; stdp_seq's 2 * sum over k of min(nnz(P_k) * N, nnz(Q_k) * M)
plus 2 * T * M * N, and stdp's 2 * (nnz(s_post) * M + nnz(s_pre) * N) plus
3 * M * N. `bound_dense_ms` beside it counts the dense products instead,
2 * M * K * N, 2 * T * B * N * N, 2 * K * T * B * M * N and 4 * B * M * N
+ 3 * M * N. The kernel table is held to `bound_ms`. For linrec, lif and
alif, whose work does not depend on the data, the two bounds are the same.
No single PyTorch call computes stdp_seq or stdp (the clip after every
step, the two products and the clip of the single step), so their
`library_ms` is null. Attention counts 4 d operations per (q, k) pair the
softmax weighs (every key of a row with no allowed key) against the peak
of its input type: 67 TFLOP/s for fp32, 989 TFLOP/s (the tensor cores)
for bf16; `bound_dense_ms` counts all T x S pairs. Its row in the kernel
line is the qwen2_32k call. The backward kernels' bytes are the planes
the function reads and writes once (`lif_bwd`: current, spikes and their
cotangent in, g_current out, T x B x N each; `linrec_bwd`: g_y, a, and y
for g_a, in, g_x and g_a out; B4 and B5: every input, cotangent and
output tensor once), the recurrent backward's scratch planes (u, and
a_{t-1} for ALIF) printed beside; B4 and B5 count their elementwise
steps and, recurrent, the dense adjoint Gu_{t+1} W^T,
2 * (T + 1) * B * N * N with g_s0. Their
rows are the dendritic train_shd step's calls (B1, B2), the train_ecg
step's (B4: the ablation's; B5's `alifrec_bwd`) and the train_alif_ff
step's (`alif_bwd`), and no single PyTorch call computes a reverse
recurrence (`library_ms` null). `spikemm_wgrad` (B3) counts the raster
(its R x K, the head rows among them), g and the output once, and
2 * nnz(raster) * N operations (dense 2 * R * K * N); its row is the
train_ecg step's three g_w products, `library_ms` `torch.matmul` on the
raster's transpose.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
WINDOW, CAPACITY = 32, 64
N_IN, N_HIDDEN, N_OUT, N_BRANCHES = 700, 64, 20, 4      # SHD DH-SNN
ECG_IN, ECG_HIDDEN, ECG_OUT, ECG_T = 4, 64, 6, 1301      # ECG SRNN
# ALIF feed-forward. The bench feeds Bernoulli(0.08), on which these
# weights fire in 1.01 % of hidden lane-steps, just over the floor below;
# at 0.2 (the rate of the SHD ablation's input) they fire in 2.11 %.
ALIF_T, ALIF_B, ALIF_RATE = 250, 64, 0.2
N_SESSIONS = 128
REPLAYS = 5            # timed replays of the trace pooled for latency
SPIKEMM_TOL = 1e-5
READOUT_TOL = 1e-4
# the least share of hidden lane-steps that must fire for a card-vs-CPU
# comparison of a layer to count as a check
MIN_HIDDEN_RATE = 0.01
# the SHD model's homogeneous ablation reads i.i.d. Bernoulli spikes at
# this rate (it is almost silent on SHD-like rasters)
HOMOGENEOUS_INPUT_RATE = 0.2

# topology_banded: `bench_topology_exec`'s program (its _MEM_SCRIPT): an
# n-neuron LIF(tau=0.8, v_th=0.6) layer fed through a sparse_coo band of
# +-64 neighbours at weight 0.05, read out by 8 LI(tau=0.9) at 0.1
BANDED_N, BANDED_BAND, BANDED_W, BANDED_OUT, BANDED_W_H = 8192, 64, 0.05, 8, 0.1
BANDED_T, BANDED_SHORT_T, BANDED_CHUNK, BANDED_RATE = 2048, 256, 64, 0.2
BANDED_REPLAYS = 5          # streams timed on the host clock after the counted one
# the streamed peak over the short stream's, as the JAX package's test holds
STREAM_PEAK_RATIO = 1.25
# train_banded: topology_banded's band (BANDED_N LIF(0.8, 0.6) behind a
# +-BANDED_BAND band at BANDED_W) with a trainable dense layer in front:
# `front` BANDED_N LIF(0.8, 0.6) fed by the N_IN inputs through w_input,
# `hidden` the band fed by `front`, `readout` BANDED_TRAIN_OUT LI(0.9)
# through w_hidden; TRAIN_STEPS clipped-SGD steps of the cross-entropy of
# the summed readout at TRAIN_LR on gen_shd_spikes(16, T=64). w_input is
# drawn as `snn_layers._dense_init` draws it, at BANDED_FRONT_SCALE /
# sqrt(N_IN): at 1 / sqrt(N_IN) the front layer fires under the 1 % floor
# on these ~1 % rasters and the band layer not at all (PERF.md § 4)
BANDED_TRAIN_B, BANDED_TRAIN_T, BANDED_TRAIN_OUT = 16, 64, 20
BANDED_FRONT_SCALE = 2.0
# serve_plastic: make_plastic_ff at the plastic_ff widths (pair STDP) served
# with EngineConfig(window=32, capacity=64, learn=True): 128 sessions of
# Bernoulli(0.15) input (numpy seed SERVE_PLASTIC_SEED), 96..152 steps
# each in ragged chunks
SERVE_PLASTIC_SESSIONS, SERVE_PLASTIC_SEED = 128, 11
# the session axis' kernel cases: sessions a window (one, ragged, full)
SESSION_S = (1, 7, CAPACITY)
# sparse_integ: `bench_snn_engine.run_sparsity_rows`, the homogeneous
# DH-SNN at n_in=4096, eager plan.run on population-packed rasters
SPARSE_IN, SPARSE_HIDDEN, SPARSE_T, SPARSE_B = 4096, 512, 256, 8
SPARSE_DENSITIES = (0.01, 0.05, 0.2, 0.5)
SPARSE_HOME_DENSITY, SPARSE_SEED = 0.05, 5
SPARSITY_SHAPE = (2048, 2048, 512)           # bench_kernels' sweep shape
# the sparse channel's case of the kernel table's row, and a case that
# `auto` routes dense (the sync checks dispatch both)
SPARSE_HOME_CASE = f"sparse_integ hidden INTEG, density {SPARSE_HOME_DENSITY}"
SPARSE_DENSE_CASE = "bench_kernels {}x{}x{}, density 0.5".format(
    *SPARSITY_SHAPE)
# plastic_ff: `bench_plasticity.measure_program`'s program, make_plastic_ff
# at 256 -> 128 -> 4, one plan.run at T=300, B=8 of Bernoulli(0.15)
PLASTIC_IN, PLASTIC_HIDDEN, PLASTIC_OUT = 256, 128, 4
PLASTIC_T, PLASTIC_B, PLASTIC_RATE = 300, 8, 0.15
PLASTIC_RULES = ("pair_stdp", "triplet_stdp", "reward_stdp",
                 "accumulated_spike")
# the learned synapse state on the card against the CPU's synapse_run fed
# with the card's own spike trains (two sum orders of one product)
LEARN_TOL = 1e-4
# the stepper engine's learned weight against the plan engine's, and the
# stdp kernel's stdp_run against the einsum one (the JAX test's tolerance)
STEP_TOL = 1e-5
# plastic_online: `examples/stdp_online.py`'s loop at the bench widths: 6
# chunks of T=200, B=4, two alternating input assemblies at 0.30 / 0.02
ONLINE_T, ONLINE_B, ONLINE_CHUNKS = 200, 4, 6
ONLINE_RULE = dict(a_plus=0.02, a_minus=0.015, w_min=-1.0, w_max=1.0)
# recurrent rows wider than 1024 neurons: several neurons per thread
WIDE_N = (1025, 2048, 4096)
# the widest row whose W_rec the scan's block route holds in shared memory
# (fp32, under the H100's 227 KB opt-in)
SMEM_W_MAX_N = 241
# the serial-chain kernels: a chain over time (the recurrent scans) or over
# the learning window's clips (stdp_seq, stdp)
SERIAL = ("lifrec", "alifrec", "stdp_seq", "stdp")
# the sweep: each serial-chain kernel's home-path call, the lane scans'
# longest path calls (linrec's and lif's of plastic_ff), alif's alif_ff
# call and the recurrent backward's train_ecg calls, cut to these step
# counts (plastic_ff's T = 300, alif_ff's 250, the ECG window's 32, the
# ECG training window's 200)
SWEEP_T = {"stdp_seq": (1, 75, 150, 300), "alifrec": (1, 8, 32),
           "lifrec": (1, 8, 32), "linrec": (1, 75, 150, 300),
           "lif": (1, 75, 150, 300), "alif": (1, 64, 128, 250),
           "lifrec_bwd": (1, 50, 100, 200), "alifrec_bwd": (1, 50, 100, 200)}
# the call each kernel's sweep cuts, by its label, where it is not the
# kernel's HOME-path call
SWEEP_CALL = {"linrec": "plastic_ff pair pre trace",
              "lif": "plastic_ff pair hidden, zero reset"}
# the lane scans' edge shapes: rows of the ECG and SHD readouts' widths
# (B = 64), rows not 16-byte aligned (B = 3) and a last warp of one lane
# (B = 1), and step counts that start or end a staged chunk of
# LANE_SCAN_CHUNK (16) steps in another place
LANE_EDGE_ROWS = ((CAPACITY, 6), (CAPACITY, 20), (3, 130), (1, 4097))
LANE_EDGE_T = (1, 15, 16, 17, 33, 300)
# the lane scans: a thread a (b, n) lane, held to their plain versions
# bit for bit, signs of zeros included
LANE_SCANS = ("linrec", "lif", "alif")
# bench_topology_exec's gather rows: (n, band, bk = bn, rows M, input rate)
GATHER_ROWS = {"exec_vs_dense": (8192, 64, 128, 64, 0.2),
               "scale_1e5": (100_000, 32, 128, 8, 0.1),
               "scale_1e6": (1_000_000, 2, 32, 8, 0.1)}
# the scale rows are also run at 1 and 64 rows
GATHER_M = (1, 8, 64)
# the gather's edge cases: (bk, bn) and rows M of a ragged topology
# (n_pre, n_post) whose posts from GATHER_EDGE_NO_FAN_IN on have no fan-in
GATHER_EDGE_BLOCKS = ((8, 8), (32, 32), (128, 128), (8, 4))
GATHER_EDGE_M = (1, 8, 9, 64, 65)
GATHER_EDGE_SHAPE, GATHER_EDGE_NO_FAN_IN = (300, 270), 250
# the sparse channel's tolerance against its plain version, and the
# gather's against the dense spikemm on dense_equivalent() (another sum
# order): the family's KernelSpec.tol, relative and absolute as the JAX
# package's sparse-channel tests hold it (outputs of the bench shapes
# reach |60|, where 1e-4 absolute is ~30 fp32 spacings)
CHANNEL_TOL = 1e-4
# the banded readout sums ~8000 spikes at 0.1 into |v| ~ 8000, where one
# fp32 spacing is ~1e-3: readouts there are held relative to their size
BANDED_READOUT_RTOL = 1e-4

# attention: fp32 within the JAX kernel test's 2e-4 (tests/test_kernels.py
# :187). bf16 is held tighter than that test's 5e-2 (:200), which is many
# times a typical output at S = 2^20: both sides compute in fp32 and round
# once, so they may differ by one bf16 spacing (rtol 2^-7), with an atol of
# 1e-2 of the reference's RMS. Every head of every case lies within a
# relative norm of 1e-2 of the plain version's. The straight-through VJP
# is within the family's KernelSpec.tol
ATTN_TOL, ATTN_VJP_TOL = 2e-4, 2e-3
ATTN_BF16_RTOL, ATTN_BF16_ATOL_RMS, ATTN_HEAD_REL = 2 ** -7, 1e-2, 1e-2
# the kernel table's attention row: one prompt of qwen2-1.5b at prefill_32k
ATTN_HOME = "qwen2_32k"
# the most fp32 score bytes one call of the plain version may hold: larger
# cases are compared head by head
ATTN_PLAIN_BYTES = 2 ** 31
PEAK_BF16_FLOPS = 989e12
# the head dims of flash attention's tensor-core route (bf16)
TC_HEAD_DIMS = (64, 128)
# train_shd: `examples/shd_dhsnn_torch.py`'s training at the published
# widths, on gen_shd_spikes(48, T=60): clipped SGD at lr 0.2, 5 steps
TRAIN_B, TRAIN_T, TRAIN_STEPS, TRAIN_LR = 48, 60, 5, 0.2
# the card's first step against the CPU's: the loss relative, each
# gradient leaf as a relative L2 error (the card sums INTEG in another
# order than the CPU's matmul)
TRAIN_LOSS_RTOL, TRAIN_LEAF_RTOL = 1e-4, 1e-3
# timed training steps (host clock, median) after TRAIN_WARMUP
TRAIN_TIMED, TRAIN_WARMUP = 5, 2
# train_ecg: `examples/ecg_srnn_torch.py`'s training at the published
# widths (4 -> 64 -> 6) on gen_ecg_qtdb(16, T=200): per-timestep
# cross-entropy, clipped SGD at lr 0.1, TRAIN_STEPS steps
ECG_TRAIN_B, ECG_TRAIN_T, ECG_TRAIN_LR = 16, 200, 0.1
# bci: the BCI decoder at the default BCIConfig (the paper's widths),
# `examples/bci_onchip_torch.py`'s training and fine-tune: 128 day-0
# trials, TRAIN_STEPS clipped-SGD steps at lr 0.05, then on each of days
# 1-3 the 25-step fine-tune of the readout at lr 0.05 on 32 trials
# (seed 100 + day) and the accuracy on 64 test trials (seed day) before
# and after; weights from torch.Generator seed 2 (the example's)
BCI_TRAIN_B, BCI_TEST_B, BCI_FEW_B = 128, 64, 32
BCI_LR, BCI_FT_LR, BCI_FT_STEPS, BCI_DAYS, BCI_SEED = 0.05, 0.05, 25, \
    (1, 2, 3), 2
# bci_forward's LIF(tau=0.8): v_th 1, the rectangle surrogate at alpha 1
BCI_LIF_TAU, BCI_V_TH, BCI_SURROGATE, BCI_ALPHA = 0.8, 1.0, "rectangle", 1.0
# the card's logits against the CPU's on trials with no flipped lane (the
# same accumulated spikes times fc_w: two sum orders of 512 terms), and a
# fine-tuned day's losses, fc_w and fc_b as relative L2 errors
BCI_LOGIT_TOL, BCI_FT_RTOL = 1e-4, 1e-4
# the backward kernels under the sigmoid surrogate: their expf against
# PyTorch's sigmoid
SIGMOID_RTOL, SIGMOID_ATOL = 1e-6, 1e-7
# the backward scans, held bit for bit as fp32 bit patterns
BWD_SCANS = ("lif_bwd", "linrec_bwd", "lifrec_bwd", "alif_bwd",
             "alifrec_bwd")
# the recurrent scans and their backward, which take `rec_route(N)`'s route
REC_KERNELS = ("lifrec", "alifrec", "lifrec_bwd", "alifrec_bwd")
SURROGATES = ("arctan", "rectangle", "sigmoid", "triangle")
# the widest row whose W_rec the recurrent backward's block route holds in
# shared memory (its Gu buffers take the forward's 241st row's room)
BWD_SMEM_W_MAX_N = 240
# the recurrent backward's warp route at rows of 33-64 neurons (either
# ADAPT: two instantiations), as its mangled name holds it: W's rows in
# registers, and the build fails if it spills or if not both are found
REC_BWD_NO_SPILL = r"rec_bwd_row_kernelILb[01]ELi64E"
# `lif_bwd` at either reset, as its mangled names hold it: the build fails
# if it spills or if not both are found
LIF_BWD_NO_SPILL = r"\dlif_bwd_kernelILb[01]EE"
# `linrec_bwd` at either decay (a value a lane, a plane), each g_a (none,
# a plane, summed) and either copy route (tensor copies, cp.async; a decay
# plane takes cp.async): the build fails if one spills or if not all nine
# are found
LINREC_BWD_NO_SPILL = r"linrec_bwd_kernelILb[01]ELi[012]ELb[01]EE"
LINREC_BWD_INSTANCES = 9
# an assumed latency of a dependent fp32 add on an H100 SM, in cycles (not
# measured here): the chain floor of the recurrent backward is T x N such
# adds (the plain version's order) at the card's highest SM clock
FADD_CYCLES = 4

SOURCES = {
    "spikemm": ("src/repro_torch/csrc/spikemm.cu",
                "src/repro/kernels/spikemm/kernel.py:61"),
    "linrec": ("src/repro_torch/csrc/linrec.cu",
               "src/repro/kernels/linrec/kernel.py:79"),
    "lif": ("src/repro_torch/csrc/lif.cu",
            "src/repro/kernels/lif/kernel.py:70"),
    "lifrec": ("src/repro_torch/csrc/lifrec.cu",
               "src/repro/kernels/lifrec/kernel.py:76"),
    "alif": ("src/repro_torch/csrc/alifrec.cu",
             "src/repro/kernels/alifrec/kernel.py:77"),
    "alifrec": ("src/repro_torch/csrc/alifrec.cu",
                "src/repro/kernels/alifrec/kernel.py:159"),
    "spikemm_sparse": ("src/repro_torch/csrc/spikemm_sparse.cu",
                       "src/repro/kernels/spikemm/sparse.py:128"),
    "spikemm_gather": ("src/repro_torch/csrc/spikemm_gather.cu",
                       "src/repro/kernels/spikemm/gather.py:218"),
    "stdp_seq": ("src/repro_torch/csrc/stdp.cu",
                 "src/repro/kernels/stdp/kernel.py:87"),
    "stdp": ("src/repro_torch/csrc/stdp.cu",
             "src/repro/kernels/stdp/kernel.py:114"),
    "attention": ("src/repro_torch/csrc/flash_attention.cu",
                  "src/repro/kernels/attention/kernel.py:106"),
    # the backward kernels replace the JAX package's custom VJPs (jnp code,
    # no Pallas kernel): B1 and B2
    "lif_bwd": ("src/repro_torch/csrc/lif_bwd.cu",
                "src/repro/kernels/lif/ops.py:78"),
    "linrec_bwd": ("src/repro_torch/csrc/linrec_bwd.cu",
                   "src/repro/kernels/linrec/ops.py:63"),
    # B4 and B5
    "lifrec_bwd": ("src/repro_torch/csrc/rec_bwd.cu",
                   "src/repro/kernels/lifrec/ops.py:86"),
    "alifrec_bwd": ("src/repro_torch/csrc/rec_bwd.cu",
                    "src/repro/kernels/alifrec/ops.py:96"),
    "alif_bwd": ("src/repro_torch/csrc/alif_bwd.cu",
                 "src/repro/kernels/alifrec/ops.py:96"),
    # B3, spikemm's weight gradient (the JAX package's g_w is its Pallas
    # spike kernel on the transposed raster)
    "spikemm_wgrad": ("src/repro_torch/csrc/spikemm_wgrad.cu",
                      "src/repro/kernels/spikemm/ops.py:186"),
    # B6, the gather's backward: kernel 10 on the transposed tables (the
    # JAX package's custom VJP runs its Pallas kernel there)
    "spikemm_gather_bwd": ("src/repro_torch/csrc/spikemm_gather_bwd.cu",
                           "src/repro/kernels/spikemm/gather.py:303"),
    # kernels 1 and 7 with a session axis (the JAX package's per-session
    # vmap of its Pallas kernels in a learning serve window)
    "spikemm_sessions": ("src/repro_torch/csrc/spikemm_sessions.cu",
                         "src/repro/kernels/spikemm/kernel.py:61"),
    "stdp_seq_sessions": ("src/repro_torch/csrc/stdp_sessions.cu",
                          "src/repro/kernels/stdp/kernel.py:87"),
}
# the kernels that compute only a gradient: no forward of their own for
# the parity harness to check (it holds them in their families' VJP legs)
BWD_ONLY = BWD_SCANS + ("spikemm_wgrad", "spikemm_gather_bwd")
# the path whose serving calls make up a kernel's row in the kernel table
HOME = {"spikemm": "shd", "linrec": "shd", "lif": "shd",
        "lifrec": "ecg_homogeneous", "alifrec": "ecg", "alif": "alif_ff",
        "spikemm_sparse": "sparse_integ", "spikemm_gather": "topology_banded",
        "stdp_seq": "plastic_ff", "stdp": "stdp_step",
        "attention": "attention", "lif_bwd": "train_shd",
        "linrec_bwd": "train_shd", "lifrec_bwd": "train_ecg",
        "alifrec_bwd": "train_ecg", "alif_bwd": "train_alif_ff",
        "spikemm_wgrad": "train_ecg", "spikemm_gather_bwd": "train_banded",
        "spikemm_sessions": "serve_plastic",
        "stdp_seq_sessions": "serve_plastic"}
# the two issue floors printed beside a kernel's time (`b6_floors`,
# `stdp_sessions_floors`): of the function's operations, of the kernel's
FLOORS = {"spikemm_gather_bwd": ("needed terms", "walked sub-tiles"),
          "stdp_seq_sessions": ("the plain order's 4K + 3 a weight-step",
                                "the kernel's 3K + 3")}
# elementwise fp32 operations per lane-step of the time kernels (the
# backward: the u step and its reset, the surrogate, the adjoint, v_{t-1},
# g_tau; ALIF also the threshold, a's step, Ga and g_rho). The recurrent
# ones add their N-term sums (`work`).
LANE_OPS = {"lif": 4, "lifrec": 6, "alif": 9, "alifrec": 10, "lif_bwd": 20,
            "lifrec_bwd": 21, "alif_bwd": 28, "alifrec_bwd": 29}


def log(*a):
    print(*a, flush=True)


def sync():
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA device")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability (9, 0) for "
                         f"sm_90a, got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
        f"capability {cap}; TF32 off for matmul and cuDNN")
    log(smi)
    return smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------


def phase_build():
    global _PASS_LIB
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    stamped = start_pass_clock_build()    # beside the library's sources
    try:
        lib = _build.build()
        lib_s = time.perf_counter() - t0
        _build.library()
    except BaseException:
        for proc, _ in stamped[0]:
            proc.kill()
            proc.wait()
        raise
    _PASS_LIB = finish_pass_clock_build(*stamped)
    secs = time.perf_counter() - t0
    log(f"build: {secs:.1f} s, the library {lib_s:.1f} s "
        f"({len(_build.sources())} sources, one nvcc -c each started "
        f"together and one link, {lib.parent}; the clock-stamped "
        f"{', '.join(PASS_SOURCES)} beside them)")
    nvcc_s = {}
    for line in (lib.parent / "build.log").read_text().splitlines():
        if line.startswith("== ") and line.endswith(" s)"):
            log("  " + line[3:])             # a source and its nvcc seconds
            name, secs_s = line[3:-3].split(" (")
            nvcc_s[name] = float(secs_s)
        elif "Compiling entry function" in line:
            log("  " + line.split("'")[1])
        elif "registers" in line or "bytes stack" in line or "error" in line:
            log("  " + line.strip())
    # the recurrent backward's warp route at the ECG's N = 64 keeps W's
    # rows in registers: it must not spill
    held = {name: spills for name, spills in ptxas_spills(
        (lib.parent / "build.log").read_text()).items()
        if re.search(REC_BWD_NO_SPILL, name)}
    if len(held) != 2:
        raise AssertionError(f"build: {len(held)} instantiation(s) match "
                             f"{REC_BWD_NO_SPILL!r}, not 2 (one an ADAPT): "
                             "the spill check would check nothing")
    for name, spills in held.items():
        if spills:
            raise AssertionError(f"build: {name} spills {spills} bytes "
                                 "(stores + loads)")
    log(f"build: {len(held)} instantiation(s) of the recurrent backward's "
        "warp route at N = 64, no spill")
    # lif_bwd keeps its chain's state in registers: no spill either
    lane = {name: spills for name, spills in ptxas_spills(
        (lib.parent / "build.log").read_text()).items()
        if re.search(LIF_BWD_NO_SPILL, name)}
    if len(lane) != 2 or any(lane.values()):
        raise AssertionError(f"build: lif_bwd's instantiations {lane} "
                             "(want its two resets, neither spilling)")
    b2 = {name: spills for name, spills in ptxas_spills(
        (lib.parent / "build.log").read_text()).items()
        if re.search(LINREC_BWD_NO_SPILL, name)}
    if len(b2) != LINREC_BWD_INSTANCES or any(b2.values()):
        raise AssertionError(f"build: linrec_bwd's instantiations {b2} "
                             f"(want {LINREC_BWD_INSTANCES}, none spilling)")
    log(f"build: nvcc seconds by source {json.dumps(nvcc_s)}; lif_bwd's "
        f"{len(lane)} instantiations and linrec_bwd's {len(b2)}, no spill")
    return {"build_s": secs, "library_s": lib_s, "nvcc_s": nvcc_s}


# the clock-stamped build of `csrc/rec_bwd.cu` (-DREC_BWD_PASS_CLOCKS),
# `csrc/alif_bwd.cu` (-DALIF_BWD_PASS_CLOCKS), `csrc/lif_bwd.cu`
# (-DLIF_BWD_PASS_CLOCKS), `csrc/spikemm_wgrad.cu` (-DWGRAD_PASS_CLOCKS)
# and `csrc/linrec_bwd.cu` (-DLINREC_BWD_PASS_CLOCKS), loaded by
# `phase_build`
_PASS_LIB = None
# the backward entry points of the stamped build, and its stamp readers
PASS_SOURCES = ("rec_bwd.cu", "alif_bwd.cu", "lif_bwd.cu",
                "spikemm_wgrad.cu", "linrec_bwd.cu")
PASS_ENTRIES = ("lifrec_bwd_f32", "alifrec_bwd_f32", "alif_bwd_f32",
                "lif_bwd_f32", "spikemm_wgrad_f32", "linrec_bwd_f32")
PASS_READERS = ("rec_bwd_pass_clocks", "alif_bwd_pass_clocks",
                "lif_bwd_pass_clocks", "wgrad_pass_clocks",
                "linrec_bwd_pass_clocks")


def start_pass_clock_build():
    """Start nvcc on `csrc/rec_bwd.cu` with -DREC_BWD_PASS_CLOCKS (the warp
    route's clock stamps by pass), `csrc/alif_bwd.cu`, `csrc/lif_bwd.cu`,
    `csrc/spikemm_wgrad.cu` and `csrc/linrec_bwd.cu` with
    -DALIF_BWD_PASS_CLOCKS, -DLIF_BWD_PASS_CLOCKS, -DWGRAD_PASS_CLOCKS and
    -DLINREC_BWD_PASS_CLOCKS (their cycles by phase):
    one `nvcc -c` a source, all started together, into `build/bwd_passes/`
    for a shared library of their own; returns ([(process, source)],
    objects, library path)."""
    from repro_torch.kernels import _build
    out = _build.BUILD_ROOT.parent / "bwd_passes"
    out.mkdir(parents=True, exist_ok=True)
    objs = [out / f"{Path(src).stem}.o" for src in PASS_SOURCES]
    procs = [(subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DREC_BWD_PASS_CLOCKS",
         "-DALIF_BWD_PASS_CLOCKS", "-DLIF_BWD_PASS_CLOCKS",
         "-DWGRAD_PASS_CLOCKS", "-DLINREC_BWD_PASS_CLOCKS", "-c",
         str(_build.CSRC / src), "-o",
         str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True), src) for src, obj in zip(PASS_SOURCES, objs)]
    return procs, objs, out / "libbwdpasses.so"


def finish_pass_clock_build(procs, objs, lib):
    """Wait for `start_pass_clock_build`'s nvcc processes and link their
    objects; the loaded library, with the backward entry points'
    signatures, its stamp readers and the package library's error strings
    (for `_build.check`)."""
    from repro_torch.kernels import _build
    for proc, src in procs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc exited {proc.returncode} building the "
                               f"clock-stamped {src}:\n{out[-3000:]}")
    link = subprocess.run([_build.nvcc_path(), *_build.LINK_FLAGS,
                           *map(str, objs), "-o", str(lib)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc exited {link.returncode} linking the "
                           f"clock-stamped {', '.join(PASS_SOURCES)}:\n"
                           f"{(link.stdout + link.stderr)[-3000:]}")
    dll = ctypes.CDLL(str(lib))
    for name in PASS_ENTRIES:
        argtypes, restype = _build.SIGNATURES[name]
        getattr(dll, name).argtypes = list(argtypes)
        getattr(dll, name).restype = restype
    for name in PASS_READERS:
        getattr(dll, name).argtypes = [ctypes.c_void_p, ctypes.c_int]
        getattr(dll, name).restype = ctypes.c_int
    dll.cuda_error_string = _build.library().cuda_error_string
    return dll


def ptxas_spills(text):
    """{kernel's mangled name: spill store + load bytes} from ptxas -v's
    output (each 'Compiling entry function' line, then its 'bytes stack
    frame' line)."""
    out, name = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "bytes spill stores" in line and name is not None:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out[name] = nums[1] + nums[2]
            name = None
    return out


# ---------------------------------------------------------------------------
# models and inputs
# ---------------------------------------------------------------------------


def make_shd(dendritic, device):
    """The SHD model at the published widths, weights from seed 0 (drawn on
    the CPU, so every device gets the same ones)."""
    from repro_torch.core.snn_layers import make_dhsnn_shd
    return make_dhsnn_shd(torch.Generator().manual_seed(0), n_in=N_IN,
                          n_hidden=N_HIDDEN, n_out=N_OUT,
                          n_branches=N_BRANCHES, dendritic=dendritic,
                          device=device)


def make_ecg(heterogeneous, device):
    """The ECG SRNN at the published widths (the `make_srnn_ecg`
    defaults), weights from seed 0."""
    from repro_torch.core.snn_layers import make_srnn_ecg
    return make_srnn_ecg(torch.Generator().manual_seed(0), n_in=ECG_IN,
                         n_hidden=ECG_HIDDEN, n_out=ECG_OUT,
                         heterogeneous=heterogeneous, device=device)


def make_alif_ff(device):
    """`benchmarks/bench_snn_engine.py`'s `shd_alif_ff` program at its
    widths, 700 -> 64 ALIF(beta=0.5) -> 20 LI(tau=0.97), with weights drawn
    as the bench draws them, from torch.Generator seed 0."""
    from repro_torch.core import events
    from repro_torch.core.neuron import ALIF, LI
    from repro_torch.core.snn_layers import ff_integrate
    from repro_torch.kernels.common import tree_to
    g = torch.Generator().manual_seed(0)
    nodes = [events.LayerNode("hidden", ALIF(beta=0.5), ff_integrate,
                              ("input",), N_HIDDEN),
             events.LayerNode("readout", LI(tau=0.97), ff_integrate,
                              ("hidden",), N_OUT)]
    params = {"hidden": {"w_input": torch.randn((N_IN, N_HIDDEN), generator=g)
                         / math.sqrt(N_IN),
                         "neuron": ALIF().param_init(g, (N_HIDDEN,))},
              "readout": {"w_hidden": torch.randn((N_HIDDEN, N_OUT),
                                                  generator=g) / 8.0}}
    return nodes, tree_to(params, device)


def make_sparse_integ(device):
    """`bench_snn_engine.run_sparsity_rows`' model: the homogeneous DH-SNN
    at n_in=4096, 512 hidden LIF, 20 LI, weights from seed 0."""
    from repro_torch.core.snn_layers import make_dhsnn_shd
    return make_dhsnn_shd(torch.Generator().manual_seed(0), n_in=SPARSE_IN,
                          n_hidden=SPARSE_HIDDEN, dendritic=False,
                          device=device)


@functools.lru_cache(maxsize=None)
def banded_net():
    """The banded topology of the topology_banded path, encoded once."""
    return banded(BANDED_N, BANDED_BAND, w=BANDED_W)


def make_train_banded(device):
    """train_banded's program: input --w_input--> BANDED_N LIF `front`
    --topology--> BANDED_N LIF `hidden` --w_hidden--> BANDED_TRAIN_OUT LI,
    the dense weights from torch.Generator seed 0 (`_dense_init`, w_input
    at BANDED_FRONT_SCALE / sqrt(N_IN)); the band has no parameter."""
    from repro_torch.core import events
    from repro_torch.core.neuron import LI, LIF
    from repro_torch.core.snn_layers import _dense_init, ff_integrate
    g = torch.Generator().manual_seed(0)
    nodes = [events.LayerNode("front", LIF(tau=0.8, v_th=0.6), ff_integrate,
                              ("input",), BANDED_N),
             events.LayerNode("hidden", LIF(tau=0.8, v_th=0.6), ff_integrate,
                              (events.Connection("front",
                                                 topology=banded_net()),),
                              BANDED_N),
             events.LayerNode("readout", LI(tau=0.9), ff_integrate,
                              ("hidden",), BANDED_TRAIN_OUT)]
    params = {"front": {"w_input": _dense_init(
                  g, N_IN, BANDED_N,
                  scale=BANDED_FRONT_SCALE / math.sqrt(N_IN))},
              "hidden": {},
              "readout": {"w_hidden": _dense_init(g, BANDED_N,
                                                  BANDED_TRAIN_OUT)}}
    return nodes, {k: {n: v.to(device) for n, v in d.items()}
                   for k, d in params.items()}


def banded_train_data(device):
    """train_banded's batch: gen_shd_spikes(16, T=64) as (T, B, N_IN)
    spikes and (B,) labels on `device`."""
    from repro_torch.data.spikes import gen_shd_spikes
    xs, ys = gen_shd_spikes(BANDED_TRAIN_B, T=BANDED_TRAIN_T, n_in=N_IN)
    x = np.ascontiguousarray(xs.transpose(1, 0, 2))
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(ys % BANDED_TRAIN_OUT).long().to(device))


def banded_loss(outs, y):
    """Cross-entropy of the readout summed over time."""
    return -torch.log_softmax(outs.sum(0), -1)[
        torch.arange(len(y), device=y.device), y].mean()


def make_banded(device):
    """`bench_topology_exec`'s program: input --topology--> BANDED_N LIF
    --w_h--> BANDED_OUT LI. The hidden layer's parameters are the
    topology alone (in its Connection)."""
    from repro_torch.core import events
    from repro_torch.core.neuron import LI, LIF
    from repro_torch.core.snn_layers import ff_integrate
    nodes = [events.LayerNode("hidden", LIF(tau=0.8, v_th=0.6), ff_integrate,
                              (events.Connection("input",
                                                 topology=banded_net()),),
                              BANDED_N),
             events.LayerNode("readout", LI(tau=0.9), ff_integrate,
                              ("hidden",), BANDED_OUT)]
    params = {"hidden": {}, "readout": {"w_hidden": BANDED_W_H * torch.ones(
        (BANDED_N, BANDED_OUT), device=device)}}
    return nodes, params


@functools.lru_cache(maxsize=None)
def banded_input():
    """(BANDED_T, 1, BANDED_N) Bernoulli(0.2) input, drawn chunk by chunk
    from numpy's generator with seed 0 as the benchmark draws it."""
    rng = np.random.default_rng(0)
    return np.concatenate([
        (rng.random((BANDED_CHUNK, 1, BANDED_N)) < BANDED_RATE).astype(
            np.float32) for _ in range(BANDED_T // BANDED_CHUNK)])


def make_plastic(rule_name, device, n_in=PLASTIC_IN, rule=None):
    """`make_plastic_ff` at the bench widths with the built-in rule
    `rule_name` (or `rule`), weights from torch.Generator seed 0."""
    from repro_torch.core import plasticity
    from repro_torch.core.snn_layers import make_plastic_ff
    rule = rule if rule is not None else plasticity.make_synapse(rule_name)
    return make_plastic_ff(torch.Generator().manual_seed(0), n_in=n_in,
                           n_hidden=PLASTIC_HIDDEN, n_out=PLASTIC_OUT,
                           rule=rule, device=device)


def plastic_input():
    """(T, B, n_in) Bernoulli(0.15) input of the plastic_ff path, from
    numpy's generator with seed 1."""
    return (np.random.default_rng(1).random(
        (PLASTIC_T, PLASTIC_B, PLASTIC_IN)) < PLASTIC_RATE).astype(np.float32)


def plastic_mod(rule_name):
    """The modulator a rule reads: a (T,) uniform reward for reward STDP,
    a teaching signal on the last step for the accumulated-spike rule (as
    the JAX package's synapse-plan tests feed them), else None."""
    if rule_name == "reward_stdp":
        return np.random.default_rng(2).random(PLASTIC_T).astype(np.float32)
    if rule_name == "accumulated_spike":
        m = np.zeros((PLASTIC_T, PLASTIC_B, PLASTIC_HIDDEN), np.float32)
        m[-1] = np.random.default_rng(3).standard_normal(
            (PLASTIC_B, PLASTIC_HIDDEN))
        return m
    return None


def online_chunk(c):
    """Chunk c of the online stream: the first half of the inputs fires at
    0.30 and the second at 0.02, swapped on odd chunks, drawn from numpy's
    generator with seed 10 + c."""
    rate = np.where((np.arange(PLASTIC_IN) < PLASTIC_IN // 2) ^ (c % 2 == 1),
                    0.30, 0.02)
    return (np.random.default_rng(10 + c).random(
        (ONLINE_T, ONLINE_B, PLASTIC_IN)) < rate).astype(np.float32)


def shd_streams(n_sessions, seed=0, rate=None):
    """{sid: (steps, 700)}: session i streams 96 + 8 * (i % 8) steps of an
    SHD-like raster (`gen_shd_spikes`), or of i.i.d. Bernoulli(`rate`)
    spikes from numpy's generator with `seed`."""
    from repro_torch.data.spikes import gen_shd_spikes
    if rate is None:
        x, _ = gen_shd_spikes(n_sessions, T=152, seed=seed, n_in=N_IN)
    else:
        x = (np.random.default_rng(seed).random((n_sessions, 152, N_IN))
             < rate).astype(np.float32)
    return {f"s{i}": x[i, :96 + 8 * (i % 8)] for i in range(n_sessions)}


def ecg_streams(n_sessions, seed=0):
    """{sid: (1301, 4)}: one level-crossing-coded ECG record per session."""
    from repro_torch.data.spikes import gen_ecg_qtdb
    x, _ = gen_ecg_qtdb(n_sessions, seed=seed, T=ECG_T)
    return {f"s{i}": x[i] for i in range(n_sessions)}


def make_trace(streams):
    """[(round, sid, chunk)]: session i arrives at round i % 8 and submits
    one chunk per round, sizes cycling 17/23/31/40."""
    sizes = (17, 23, 31, 40)
    ev = []
    for i, (sid, x) in enumerate(streams.items()):
        off, r = 0, i % 8
        while off < len(x):
            n = min(sizes[(i + r) % len(sizes)], len(x) - off)
            ev.append((r, sid, x[off:off + n]))
            off += n
            r += 1
    ev.sort(key=lambda e: e[0])
    return ev


def side_by_side(streams, n_in):
    """(T_max, n_sessions, n_in) input of every session, zero-padded."""
    T = max(len(v) for v in streams.values())
    x = np.zeros((T, len(streams), n_in), np.float32)
    for b, v in enumerate(streams.values()):
        x[:len(v), b] = v
    return x


@dataclasses.dataclass(frozen=True)
class ServePath:
    name: str
    model: str
    make_model: Callable
    streams: Callable[[], Dict[str, np.ndarray]]
    per_window: Dict[str, int]
    input: str
    timed: bool = True


PATHS = (
    ServePath("shd", f"dhsnn_shd {N_IN}->{N_HIDDEN}x{N_BRANCHES}->{N_OUT}",
              lambda dev: make_shd(True, dev),
              lambda: shd_streams(N_SESSIONS),
              {"spikemm": 2, "linrec": 2, "lif": 1}, "gen_shd_spikes"),
    ServePath("shd_homogeneous",
              f"dhsnn_shd homogeneous {N_IN}->{N_HIDDEN}->{N_OUT}",
              lambda dev: make_shd(False, dev),
              lambda: shd_streams(32, rate=HOMOGENEOUS_INPUT_RATE),
              {"spikemm": 2, "linrec": 1, "lif": 1},
              f"bernoulli({HOMOGENEOUS_INPUT_RATE})", timed=False),
    ServePath("ecg", f"srnn_ecg {ECG_IN}->{ECG_HIDDEN} recurrent "
              f"ALIF->{ECG_OUT}", lambda dev: make_ecg(True, dev),
              lambda: ecg_streams(N_SESSIONS),
              {"spikemm": 2, "alifrec": 1, "linrec": 1}, "gen_ecg_qtdb"),
    ServePath("ecg_homogeneous", f"srnn_ecg homogeneous {ECG_IN}->"
              f"{ECG_HIDDEN} recurrent LIF->{ECG_OUT}",
              lambda dev: make_ecg(False, dev), lambda: ecg_streams(32),
              {"spikemm": 2, "lifrec": 1, "linrec": 1}, "gen_ecg_qtdb"),
)


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------


_SLEEP_CYCLES_PER_MS = None


def sleep_cycles_per_ms():
    """How many `torch.cuda._sleep` cycles the card spins per millisecond,
    measured once with CUDA events."""
    global _SLEEP_CYCLES_PER_MS
    if _SLEEP_CYCLES_PER_MS is None:
        cycles = 10_000_000
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        sync()
        _SLEEP_CYCLES_PER_MS = cycles / start.elapsed_time(end)
    return _SLEEP_CYCLES_PER_MS


def cuda_ms(fn, iters, warmup=3):
    """Device ms per call of `fn`, from CUDA events.

    The calls are queued behind a `torch.cuda._sleep` that outlasts the
    host's time to issue all of them, so the events bracket the card's own
    work (for a wrapper, every kernel it launches) with no host gaps
    between calls. The sleep's length comes from its measured rate and the
    host's measured issue time."""
    for _ in range(warmup):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    issue_ms = (time.perf_counter() - t0) * 1e3
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * issue_ms * sleep_cycles_per_ms()) + 1000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


_FLOOR_MS = None


def launch_floor_ms():
    """`cuda_ms` of a one-element in-place `add_`: the least a launch
    costs back to back under the same sleep-hidden issue. It is no kernel
    of the port; a call whose bound lies far under it is held to
    max(bound, floor). Measured once, logged on its own line."""
    global _FLOOR_MS
    if _FLOOR_MS is None:
        one = torch.zeros(1, device=DEV)
        _FLOOR_MS = cuda_ms(lambda: one.add_(1.0), iters=200)
        log(f"launch floor: {_FLOOR_MS:.5f} ms (cuda_ms of a one-element "
            "add_ on the card)")
    return _FLOOR_MS


@functools.lru_cache(maxsize=None)
def sm_max_clock_mhz():
    """The card's highest SM clock in MHz (`nvidia-smi`'s clocks.max.sm,
    read once): a clock sampled after a timing may read an idle one."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True,
        timeout=60).stdout.split()[0]
    return int(out)


def chain_floor_ms(T, N):
    """A floor under a reverse pass in the order its plain version fixes:
    T steps, each a chain of N dependent rounded operations of FADD_CYCLES
    cycles (assumed) at the highest SM clock; the recurrent backward's an
    N-term sum (rec_t), B2's a product and an add (N = 2)."""
    return T * N * FADD_CYCLES / (sm_max_clock_mhz() * 1e3)


def bound(bytes_, flops):
    t_bytes = bytes_ / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _decays(params):
    nb = params["hidden"]["neuron"]
    return (torch.sigmoid(nb["w_tau"]).contiguous(),
            torch.sigmoid(nb["w_rho"]).contiguous())


def shd_window(params):
    """The tensors one cold serving window hands each kernel: a 32-step
    window of 64 SHD-like sessions through the DH-SNN, chained through the
    kernels themselves."""
    from repro_torch.data.spikes import gen_shd_spikes
    from repro_torch.kernels.lif.ops import lif_cuda
    from repro_torch.kernels.linrec.ops import linrec_cuda
    from repro_torch.kernels.spikemm.ops import spikemm_cuda
    dev = DEV
    x = gen_shd_spikes(CAPACITY, T=WINDOW, seed=7,
                       n_in=N_IN)[0].transpose(1, 0, 2)
    s_in = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    s_in = s_in.reshape(WINDOW * CAPACITY, N_IN)
    w = params["hidden"]["w_input"]
    w2 = w.permute(1, 0, 2).reshape(N_IN, N_BRANCHES * N_HIDDEN).contiguous()
    nb = params["hidden"]["neuron"]
    tau_d = torch.sigmoid(nb["w_tau_d"]).reshape(-1)
    tau_s = torch.sigmoid(nb["w_tau_s"]).contiguous()
    cur = spikemm_cuda(s_in, w2).reshape(WINDOW, CAPACITY, -1)
    a_br = tau_d.expand(cur.shape)
    h0_br = torch.zeros(CAPACITY, N_BRANCHES * N_HIDDEN, device=dev)
    d, _ = linrec_cuda(a_br, cur, h0_br)
    d4 = d.reshape(WINDOW, CAPACITY, N_BRANCHES, N_HIDDEN)
    soma = d4[:, :, 0]
    for k in range(1, N_BRANCHES):
        soma = soma + d4[:, :, k]
    soma = soma.contiguous()
    v0 = torch.zeros(CAPACITY, N_HIDDEN, device=dev)
    spk, _ = lif_cuda(soma, tau_s, v0, 1.0, "zero")
    s_h = spk.reshape(WINDOW * CAPACITY, N_HIDDEN)
    w_out = params["readout"]["w_hidden"]
    cur_o = spikemm_cuda(s_h, w_out).reshape(WINDOW, CAPACITY, N_OUT)
    a_o = torch.full((N_OUT,), 0.97, device=dev).expand(cur_o.shape)
    h0_o = torch.zeros(CAPACITY, N_OUT, device=dev)
    return {
        "spikemm": [("hidden INTEG", (s_in, w2)),
                    ("readout INTEG", (s_h, w_out))],
        "linrec": [("DH-LIF branches", (a_br, cur, h0_br)),
                   ("LI readout", (a_o, cur_o, h0_o))],
        "lif": [("DH-LIF soma", (soma, tau_s, v0))]}


def ecg_window(heterogeneous):
    """What the 11th 32-step window of 64 ECG records hands each kernel:
    the state after 10 windows of `plan.run` on the card, then the
    window's INTEG, hidden layer and readout chained through the
    kernels."""
    from repro_torch.core import plan
    from repro_torch.kernels.alifrec.ops import alifrec_cuda
    from repro_torch.kernels.lifrec.ops import lifrec_cuda
    from repro_torch.kernels.spikemm.ops import spikemm_cuda
    nodes, params = make_ecg(heterogeneous, DEV)
    x = torch.from_numpy(side_by_side(ecg_streams(CAPACITY, seed=5),
                                      ECG_IN)[:11 * WINDOW]).to(DEV)
    st, _, _ = plan.run(nodes, params, x[:10 * WINDOW], device=DEV)
    hp = params["hidden"]
    s_in = x[10 * WINDOW:].reshape(WINDOW * CAPACITY, ECG_IN).contiguous()
    cur = spikemm_cuda(s_in, hp["w_input"]).reshape(WINDOW, CAPACITY, -1)
    h = st["hidden"]
    if heterogeneous:
        tau, rho = _decays(params)
        name = "alifrec"
        args = (cur, hp["w_self"], tau, rho, h["v"], h["a"], h["out"], 1.0,
                0.5)
        spk = alifrec_cuda(*args)[0]
    else:
        tau = torch.full((ECG_HIDDEN,), 0.9, device=DEV)
        name = "lifrec"
        args = (cur, hp["w_self"], tau, h["v"], h["out"], 1.0)
        spk = lifrec_cuda(*args)[0]
    s_h = spk.reshape(WINDOW * CAPACITY, ECG_HIDDEN)
    w_out = params["readout"]["w_hidden"]
    cur_o = spikemm_cuda(s_h, w_out).reshape(WINDOW, CAPACITY, ECG_OUT)
    a_o = torch.full((ECG_OUT,), 0.95, device=DEV).expand(cur_o.shape)
    return {name: [("ECG hidden", args)],
            "spikemm": [("ECG input INTEG, K=4", (s_in, hp["w_input"])),
                        ("ECG readout INTEG, N=6", (s_h, w_out))],
            "linrec": [("ECG LI readout", (a_o, cur_o,
                                           st["readout"]["v"]))]}


def alif_ff_run_inputs():
    """The `alif` call of the ALIF feed-forward path: the hidden layer of
    one `plan.run` of Bernoulli(ALIF_RATE) input at T=250, B=64, from
    cold."""
    from repro_torch.kernels.spikemm.ops import spikemm_cuda
    _, params = make_alif_ff(DEV)
    x = torch.from_numpy(alif_ff_input()).to(DEV)
    cur = spikemm_cuda(x.reshape(ALIF_T * ALIF_B, N_IN),
                       params["hidden"]["w_input"]).reshape(
        ALIF_T, ALIF_B, N_HIDDEN)
    tau, rho = _decays(params)
    z = torch.zeros(ALIF_B, N_HIDDEN, device=DEV)
    return (cur, tau, rho, z, z.clone(), 1.0, 0.5)


def alif_ff_input():
    return (np.random.default_rng(0).random((ALIF_T, ALIF_B, N_IN))
            < ALIF_RATE).astype(np.float32)


def ragged_cases():
    """Shapes no serving window has: T=37, B=3, N=130, N=300 and N=1024
    from a nonzero state (both W_rec storage paths of the recurrent
    kernels, and the widest row of one neuron a thread)."""
    g = torch.Generator().manual_seed(3)

    def rnd(*shape, lo=0.0, hi=1.0):
        return (lo + (hi - lo) * torch.rand(shape, generator=g)).to(DEV)

    cases = {"spikemm": [("ragged", (
        (torch.rand((1000, N_IN), generator=g) < 0.012).float().to(DEV),
        torch.randn((N_IN, 257), generator=g).to(DEV)))],
        "linrec": [("ragged, full decay plane", (
            rnd(37, 3, 130, lo=0.5, hi=0.99),
            torch.randn((37, 3, 130), generator=g).to(DEV),
            torch.randn((3, 130), generator=g).to(DEV)))],
        "lif": [], "lifrec": [], "alif": [], "alifrec": []}
    cur130 = (0.6 * torch.randn((37, 3, 130), generator=g)).to(DEV)
    tau130 = rnd(130, lo=0.7, hi=0.98)
    z130 = torch.zeros((3, 130), device=DEV)
    cases["lif"] = [("ragged, zero reset", (cur130, tau130, z130, 1.0,
                                            "zero")),
                    ("ragged, subtract reset", (cur130, tau130, z130, 1.0,
                                                "subtract"))]
    for n in (130, 300, 1024):
        cur = (0.8 * torch.randn((37, 3, n), generator=g)).to(DEV)
        w = (0.4 / math.sqrt(n) * torch.randn((n, n), generator=g)).to(DEV)
        tau, rho = rnd(n, lo=0.7, hi=0.98), rnd(n, lo=0.85, hi=0.99)
        v0, a0 = rnd(3, n, lo=-0.5, hi=0.9), rnd(3, n, hi=2.0)
        s0 = (torch.rand((3, n), generator=g) < 0.3).float().to(DEV)
        label = f"ragged N={n}"
        cases["lifrec"].append((label, (cur, w, tau, v0, s0, 1.0)))
        cases["alif"].append((label, (cur, tau, rho, v0, a0, 1.0, 1.8)))
        cases["alifrec"].append((label, (cur, w, tau, rho, v0, a0, s0, 1.0,
                                         0.5)))
    return cases


def wide_rec_cases():
    """`lifrec` and `alifrec` on rows wider than a block's 1024 threads
    (several neurons per thread), W_rec through L2, from a nonzero state:
    ragged (T=37, B=3) and ECG-window-shaped (T=32, B=64) at each of
    WIDE_N. The window-shaped N=2048 calls are timed."""
    g = torch.Generator().manual_seed(6)

    def rnd(*shape, lo=0.0, hi=1.0):
        return (lo + (hi - lo) * torch.rand(shape, generator=g)).to(DEV)

    cases = {"lifrec": [], "alifrec": []}
    for n in WIDE_N:
        w = (0.4 / math.sqrt(n) * torch.randn((n, n), generator=g)).to(DEV)
        tau, rho = rnd(n, lo=0.7, hi=0.98), rnd(n, lo=0.85, hi=0.99)
        for T, B, label in ((37, 3, f"ragged N={n}"),
                            (WINDOW, CAPACITY, f"ECG window shape N={n}")):
            cur = (0.8 * torch.randn((T, B, n), generator=g)).to(DEV)
            v0, a0 = rnd(B, n, lo=-0.5, hi=0.9), rnd(B, n, hi=2.0)
            s0 = (torch.rand((B, n), generator=g) < 0.3).float().to(DEV)
            timed = n == 2048 and B == CAPACITY
            cases["lifrec"].append(Case(label, (cur, w, tau, v0, s0, 1.0),
                                        timed=timed, plain_iters=2))
            cases["alifrec"].append(Case(
                label, (cur, w, tau, rho, v0, a0, s0, 1.0, 0.5), timed=timed,
                plain_iters=2))
    return cases


def rec_route_cases():
    """`lifrec` and `alifrec` on both sides of the scan's route edges: N =
    1, 31, 32, 33 (one ballot word and two), 64 (the ECG SRNN),
    REC_WARP_MAX_N - 1, REC_WARP_MAX_N, REC_WARP_MAX_N + 1 (the last warp
    row and the first block row) and 1024, each at B = 1, 3 and 64 (one
    row a block, a partial block, full blocks) over T = 37 steps (three
    stages of current: the ring wraps), from a nonzero state; the ECG
    window's shape at T = 1; and rows that fire in most steps, so that
    most mask bits are set. Inputs biased to fire in every case."""
    from repro_torch.kernels.common import REC_WARP_MAX_N
    g = torch.Generator().manual_seed(8)

    def rnd(*shape, lo=0.0, hi=1.0):
        return (lo + (hi - lo) * torch.rand(shape, generator=g)).to(DEV)

    cases = {"lifrec": [], "alifrec": []}

    def add(label, T, B, n, bias):
        cur = (0.8 * torch.randn((T, B, n), generator=g) + bias).to(DEV)
        w = (0.4 / math.sqrt(n) * torch.randn((n, n), generator=g)).to(DEV)
        tau, rho = rnd(n, lo=0.7, hi=0.98), rnd(n, lo=0.85, hi=0.99)
        v0, a0 = rnd(B, n, lo=-0.5, hi=0.9), rnd(B, n, hi=2.0)
        s0 = (torch.rand((B, n), generator=g) < 0.3).float().to(DEV)
        cases["lifrec"].append(Case(label, (cur, w, tau, v0, s0, 1.0)))
        cases["alifrec"].append(Case(label, (cur, w, tau, rho, v0, a0, s0,
                                             1.0, 0.5)))

    for n in sorted({1, 31, 32, 33, 64, REC_WARP_MAX_N - 1, REC_WARP_MAX_N,
                     REC_WARP_MAX_N + 1, 1024}):
        for B in (1, 3, CAPACITY):
            add(f"route edge N={n}, B={B}, T=37", 37, B, n, 0.3)
    add("ECG window shape at T=1", 1, CAPACITY, ECG_HIDDEN, 0.3)
    for n in (ECG_HIDDEN, REC_WARP_MAX_N):
        add(f"firing most steps, N={n}", 37, 3, n, 2.5)
    return cases


def linrec_edge_cases():
    """`linrec` where a lane scan has edges: rows of D = 6 and 20 (the ECG
    and SHD readouts, B = 64), D = 130 (B = 3: rows not 16-byte aligned)
    and 4097 lanes (B = 1: a last warp of one lane), each at T = 1, 31, 33
    (not a multiple of a staged chunk) and 300, with a per-neuron decay
    broadcast over T and B (stride 0) and with a full decay plane; and
    rows of whole warps whose x starts off 16-byte alignment."""
    g = torch.Generator().manual_seed(10)
    out = []
    for B, D in ((CAPACITY, 6), (CAPACITY, 20), (3, 130), (1, 4097)):
        for T in (1, 31, 33, 300):
            x = torch.randn((T, B, D), generator=g).to(DEV)
            h0 = torch.randn((B, D), generator=g).to(DEV)
            per_neuron = (0.5 + 0.49 * torch.rand((D,), generator=g)).to(DEV)
            plane = (0.5 + 0.49 * torch.rand((T, B, D), generator=g)).to(DEV)
            for kind, a in (("stride-0 decay", per_neuron.expand(x.shape)),
                            ("full decay plane", plane)):
                out.append(Case(f"edge ({T}, {B}, {D}), {kind}", (a, x, h0)))
    x = off_alignment(torch.randn((33, CAPACITY, 20), generator=g).to(DEV))
    h0 = torch.randn((CAPACITY, 20), generator=g).to(DEV)
    a = (0.5 + 0.49 * torch.rand((20,), generator=g)).to(DEV)
    out.append(Case(f"rows of whole warps, x off 16-byte alignment "
                    f"(33, {CAPACITY}, 20), stride-0 decay",
                    (a.expand(x.shape), x, h0)))
    return out


def stdp_edge_cases():
    """`stdp` on inputs that are not 16-byte aligned, as `stdp_run` hands
    it `pre_spikes[t]` slices: at B = 3, M = 130, N = 70 the slice at t = 1
    starts B * n elements in (fp32 and bf16; whole pairs, which the kernel
    reads as one load); rows of N = 128 whose planes start one element
    into their buffer (no pair aligned: scalar loads); and B = 0 (the
    weight only clipped) and B = 1."""
    g = torch.Generator().manual_seed(11)
    kw = dict(a_plus=0.05, a_minus=0.06, w_min=-0.4, w_max=0.4)

    def planes(B, M, N, dt, lead):
        """x_pre, s_post, s_pre, x_post of one step, each a view one step
        and `lead` elements into a buffer of two steps."""
        pre = torch.rand((2, B, M), generator=g)
        pre[1] = (pre[1] < 0.2).float()
        post = torch.rand((2, B, N), generator=g)
        post[0] = (post[0] < 0.2).float()
        views = []
        for buf, k in ((pre, 0), (post, 0), (pre, 1), (post, 1)):
            n = buf[k].numel()
            flat = torch.zeros((lead + 2 * n,), dtype=dt, device=DEV)
            flat[lead + n:].copy_(buf[k].reshape(-1))
            views.append(flat[lead + n:].view(buf[k].shape))
        return views

    out = []
    for dt in (torch.float32, torch.bfloat16):
        for B, M, N, lead, label in ((3, 130, 70, 0, "pre_spikes[1] slices"),
                                     (3, 130, 128, 1, "one element in")):
            tr = planes(B, M, N, dt, lead)
            if all(t.data_ptr() % 16 == 0 for t in tr):
                raise AssertionError(f"stdp edge [{label}]: aligned")
            w = (0.5 * torch.randn((M, N), generator=g)).to(DEV)
            out.append(Case(f"{label} ({B}, {M}, {N}), {str(dt)[6:]}, "
                            "not 16-byte aligned", (*tr, w), kw=kw))
    for B in (0, 1):
        w = (0.5 * torch.randn((130, 70), generator=g)).to(DEV)
        tr = planes(B, 130, 70, torch.float32, 0)
        out.append(Case(f"B={B} (130, 70)", (*tr, w), kw=kw))
    return out


def stdp_seq_edge_cases():
    """`stdp_seq` at the plastic_ff widths (256 x 128, B = 8) where the
    kernel's groups of STDP_SEQ_GROUP steps have edges: T = 1, G - 1, G + 1
    (K = 2), four terms at T = 75, a window of T = 2000; rows of a step
    that cross its stages (K = 4, B = 5: a term ends mid-stage) and a
    single batch row (K = 3, B = 1, T = 37); ragged tiles with rows of
    whole float4s (260 x 100). Bounds of +-0.4 that the trajectory hits."""
    from repro_torch.kernels._build import STDP_SEQ_GROUP as G
    g = torch.Generator().manual_seed(9)
    amps4 = (0.05, -0.06, 0.03, -0.04)
    out = []
    for K, T, B, M, N, label in (
            (2, 1, 8, 256, 128, "T=1"),
            (2, G - 1, 8, 256, 128, f"T=G-1={G - 1}"),
            (2, G + 1, 8, 256, 128, f"T=G+1={G + 1}"),
            (4, 75, 8, 256, 128, "T=75"),
            (2, 2000, 8, 256, 128, "long window T=2000"),
            (4, 37, 5, 256, 128, "B=5, terms end mid-stage"),
            (3, 37, 1, 256, 128, "B=1"),
            (2, G + 3, 8, 260, 100, "ragged 260 x 100, float4 rows")):
        P = torch.rand((K, T * B, M), generator=g).to(DEV)
        Q = (torch.rand((K, T * B, N), generator=g) < 0.2).float().to(DEV)
        w = (0.3 * torch.randn((M, N), generator=g)).to(DEV)
        out.append(Case(f"{label}, K={K}", (P, Q, w), kw=dict(
            amps=amps4[:K], w_min=-0.4, w_max=0.4, batch=B)))
    return out


def stdp_seq_no_rows():
    """`csrc/stdp.cu`'s stdp_seq at B = 0 (steps with no batch rows, which
    the wrapper cannot express: it derives T from the rows), called through
    the C entry point at T = 5, K = 3 on the card, against the plain loop:
    dw = sum_k amp_k * 0 from zeros, then the clip, T times."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.stdp.ops import stdp_seq_plan
    K, T, M, N = 3, 5, 130, 140
    amps = (0.5, -0.25, 0.125)
    w = (0.7 * torch.randn((M, N), generator=torch.Generator().manual_seed(
        4))).to(DEV)
    P = torch.zeros((K, 0, M), device=DEV)
    Q = torch.zeros((K, 0, N), device=DEV)
    out = torch.empty_like(w)
    amp = (ctypes.c_float * K)(*amps)
    code = _build.library().stdp_seq_f32(
        P.data_ptr(), Q.data_ptr(), w.data_ptr(), out.data_ptr(),
        ctypes.addressof(amp), K, T, 0, M, N, *stdp_seq_plan(M, N)[:2],
        -0.5, 0.5, torch.cuda.current_stream().cuda_stream)
    _build.check("stdp_seq", code)
    want = w.clone()
    for _ in range(T):
        dw = torch.zeros_like(w)
        for a in amps:
            dw = dw + torch.tensor(a, device=DEV) * torch.zeros_like(w)
        want = torch.clamp(want + dw, -0.5, 0.5)
    sync()
    if not torch.equal(out, want) or torch.equal(out, w):
        raise AssertionError("stdp_seq at B=0: not its plain loop bit for "
                             "bit, or nothing clipped")
    log(f"kernel stdp_seq [B=0 through the C entry point, K={K}, T={T}, "
        f"{M} x {N}]: clips T times, equal to the plain loop bit for bit")


def plastic_seq_cases(rules):
    """One timed `stdp_seq` Case per rule: the term planes of the
    plastic_ff path's one plan.run on the card, captured at the kernel's
    call. The pair rule's is the path's home call."""
    from repro_torch.core import plan
    captured = []
    real_seq = plan.stdp_seq

    def spy_seq(P, Q, w, **kw):
        captured.append((P, Q, w, kw))
        return real_seq(P, Q, w, **kw)

    x = torch.from_numpy(plastic_input()).to(DEV)
    plan.stdp_seq = spy_seq
    try:
        for rule_name in rules:
            nodes, params = make_plastic(rule_name, DEV)
            m = plastic_mod(rule_name)
            plan.run(nodes, params, x, device=DEV,
                     mod=None if m is None else torch.from_numpy(m).to(DEV))
    finally:
        plan.stdp_seq = real_seq
    return [Case(f"plastic_ff {r}, K={P.shape[0]}", (P, Q, w), kw=kw,
                 path="plastic_ff" if r == "pair_stdp" else None, timed=True,
                 plain_iters=2)
            for r, (P, Q, w, kw) in zip(rules, captured)]


def plastic_linrec_cases():
    """The `linrec` calls of the plastic_ff path's pair-rule plan.run on
    the card, captured at `plan.linrec`: the LI readout (T=300, B=8, N=4)
    and the learning pass's two trace scans, pre (256 lanes a row) and post
    (128). Timed, with the path tag plastic_ff (not linrec's HOME, so the
    kernel table's SHD row stays the serving window's)."""
    from repro_torch.core import plan
    captured = []
    real = plan.linrec

    def spy(a, x, h0):
        captured.append((a, x, h0))
        return real(a, x, h0)

    x = torch.from_numpy(plastic_input()).to(DEV)
    nodes, params = make_plastic("pair_stdp", DEV)
    plan.linrec = spy
    try:
        plan.run(nodes, params, x, device=DEV)
    finally:
        plan.linrec = real
    names = {PLASTIC_IN: "pre trace", PLASTIC_HIDDEN: "post trace",
             PLASTIC_OUT: "LI readout"}
    if sorted(x.shape[2] for _, x, _ in captured) != sorted(names):
        raise AssertionError(f"plastic_ff pair rule: linrec calls of shapes "
                             f"{[tuple(x.shape) for _, x, _ in captured]}")
    return [Case(f"plastic_ff pair {names[args[1].shape[2]]}", args,
                 path="plastic_ff", timed=True, plain_iters=2)
            for args in captured]


def path_lif_cases():
    """The `lif` calls of four paths' main runs on the card, captured at
    `plan.lif_scan`: the plastic_ff pair rule's hidden layer (T=300, B=8,
    N=128, zero reset), plastic_online's first chunk (200, 4, 128),
    sparse_integ at its home density (256, 8, 512) and topology_banded's
    second streamed chunk (64, 1, 8192), from the state the first left.
    Timed, each tagged with its own path (not lif's HOME, so the kernel
    table's row 2 stays the SHD window's)."""
    from repro_torch.core import plan, plasticity
    captured = []
    real = plan.lif_scan

    def spy(cur, tau, v0, v_th=1.0, surrogate="rectangle", alpha=1.0,
            reset="zero"):
        captured.append((cur.clone(), tau.clone(), v0.clone(), v_th, reset))
        return real(cur, tau, v0, v_th, surrogate, alpha, reset)

    runs = []
    nodes, params = make_plastic("pair_stdp", DEV)
    runs.append(("plastic_ff", "plastic_ff pair hidden", lambda: plan.run(
        nodes, params, torch.from_numpy(plastic_input()).to(DEV),
        device=DEV)))
    rule = plasticity.pair_stdp(**ONLINE_RULE)
    o_nodes, o_params = make_plastic("pair_stdp", DEV, rule=rule)
    runs.append(("plastic_online", "plastic_online first chunk",
                 lambda: plan.run(o_nodes, o_params, torch.from_numpy(
                     online_chunk(0)).to(DEV), device=DEV)))
    s_nodes, s_params = make_sparse_integ(DEV)
    s_x = packed_raster(SPARSE_T * SPARSE_B, SPARSE_IN, SPARSE_HOME_DENSITY,
                        SPARSE_SEED).reshape(SPARSE_T, SPARSE_B, SPARSE_IN)
    runs.append(("sparse_integ", f"sparse_integ hidden, density "
                 f"{SPARSE_HOME_DENSITY}", lambda: plan.run(
                     s_nodes, s_params, torch.from_numpy(s_x).to(DEV),
                     device=DEV)))
    b_nodes, b_params = make_banded(DEV)
    b_x = banded_input()[:2 * BANDED_CHUNK]
    runs.append(("topology_banded", "topology_banded second chunk",
                 lambda: list(plan.run_stream(
                     b_nodes, b_params, (torch.from_numpy(
                         b_x[i:i + BANDED_CHUNK]).to(DEV)
                         for i in (0, BANDED_CHUNK)), device=DEV))))
    out = []
    plan.lif_scan = spy
    try:
        for path, label, run in runs:
            captured.clear()
            run()
            args = captured[-1]             # banded: the second chunk's
            out.append(Case(f"{label}, {args[4]} reset", args, path=path,
                            timed=True, plain_iters=2))
    finally:
        plan.lif_scan = real
    shapes = [tuple(c.args[0].shape) for c in out]
    want = [(PLASTIC_T, PLASTIC_B, PLASTIC_HIDDEN),
            (ONLINE_T, ONLINE_B, PLASTIC_HIDDEN),
            (SPARSE_T, SPARSE_B, SPARSE_HIDDEN), (BANDED_CHUNK, 1, BANDED_N)]
    if shapes != want:
        raise AssertionError(f"path lif calls of shapes {shapes}, expected "
                             f"{want}")
    if not out[-1].args[2].abs().sum() > 0:
        raise AssertionError("topology_banded's second chunk starts from a "
                             "zero membrane")
    return out


def lane_fire_edge_cases():
    """{"lif": [Case], "alif": [Case]} where a lane scan has edges: rows of
    LANE_EDGE_ROWS at each of LANE_EDGE_T steps, from a nonzero v0 (and
    a0), a quarter of the lanes driven to fire in most steps; `lif` with
    both resets. And signed zeros at a threshold of 0 and of -0.5: lanes
    whose current and v0 are -0.0, so the resets meet u = -0 on both sides
    of the threshold (the check is bit for bit, signs of zeros included);
    and rows of whole warps whose current starts off 16-byte alignment.
    Untimed."""
    g = torch.Generator().manual_seed(12)

    def rnd(*shape, lo=0.0, hi=1.0):
        return (lo + (hi - lo) * torch.rand(shape, generator=g)).to(DEV)

    out = {"lif": [], "alif": []}

    def add(label, cur, v_th):
        T, B, N = cur.shape
        tau, rho = rnd(N, lo=0.7, hi=0.98), rnd(N, lo=0.85, hi=0.99)
        v0, a0 = rnd(B, N, lo=-0.5, hi=0.9), rnd(B, N, hi=2.0)
        if v_th <= 0:
            zero = (torch.arange(B * N, device=DEV) % 5 == 0).reshape(B, N)
            cur = torch.where(zero, torch.full_like(cur, -0.0), cur)
            v0 = torch.where(zero, torch.full_like(v0, -0.0), v0)
        for reset in ("zero", "subtract"):
            out["lif"].append(Case(f"{label}, {reset} reset",
                                   (cur, tau, v0, v_th, reset)))
        out["alif"].append(Case(label, (cur, tau, rho, v0, a0, v_th, 1.8)))

    for B, N in LANE_EDGE_ROWS:
        for T in LANE_EDGE_T:
            hot = (torch.rand((B, N), generator=g) < 0.25).float() * 2.5
            cur = (0.6 * torch.randn((T, B, N), generator=g) + hot).to(DEV)
            add(f"edge ({T}, {B}, {N})", cur, 1.0)
    for v_th in (0.0, -0.5):
        cur = (0.6 * torch.randn((33, CAPACITY, 20), generator=g)).to(DEV)
        add(f"signed zeros (33, {CAPACITY}, 20), v_th={v_th}", cur, v_th)
    cur = off_alignment((0.6 * torch.randn((33, CAPACITY, 20), generator=g)
                         + 0.8).to(DEV))
    add(f"rows of whole warps, current off 16-byte alignment "
        f"(33, {CAPACITY}, 20)", cur, 1.0)
    return out


def off_alignment(t):
    """A contiguous copy of `t` whose data starts 4 bytes past a 16-byte
    boundary: the lane scans then copy it a lane a thread even where its
    rows are whole warps."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    if out.data_ptr() % 16 == 0:
        raise AssertionError("off_alignment: the copy is 16-byte aligned")
    return out


def stdp_cases():
    """The learning kernels' cases. `stdp_seq`: each rule's term planes
    from the plastic_ff path's one plan.run on the card (captured at the
    kernel's call), `_make_seq_inputs`' ragged shape (K=2, T=12, B=4,
    130 x 140), four term planes, and bounds of +-0.4 that the trajectory
    hits. `stdp`: one step of the stdp_step path's stdp_run (step 150, its
    traces warm), and the JAX kernel tests' (B, M, N) with fp32 and bf16
    traces and their +-0.4 clip."""
    from repro_torch.core import plasticity
    from repro_torch.kernels.stdp import ops as stdp_ops
    cases = {"stdp_seq": plastic_seq_cases(PLASTIC_RULES), "stdp": []}
    cases["stdp_seq"] += stdp_seq_edge_cases()
    g = torch.Generator().manual_seed(7)
    for K, amps, lo, hi, label in (
            (2, (0.01, -0.012), -1.0, 1.0, "ragged K=2 (JAX make_inputs)"),
            (4, (0.02, -0.015, 0.01, -0.03), -1.0, 1.0, "ragged K=4"),
            (2, (0.05, -0.06), -0.4, 0.4, "ragged K=2, clip +-0.4")):
        P = torch.rand((K, 12 * 4, 130), generator=g).to(DEV)
        Q = (torch.rand((K, 12 * 4, 140), generator=g) < 0.2).float().to(DEV)
        w = (0.5 * torch.randn((130, 140), generator=g)).to(DEV)
        cases["stdp_seq"].append(Case(label, (P, Q, w), kw=dict(
            amps=amps, w_min=lo, w_max=hi, batch=4)))

    step_args = []
    real_upd = stdp_ops.stdp_update

    def spy_upd(*args, **kw):
        step_args.append((args, kw))
        return real_upd(*args, **kw)

    pre, post, w = stdp_step_inputs()
    stdp_ops.stdp_update = spy_upd
    try:
        plasticity.stdp_run(plasticity.STDPConfig(), w, pre[:151], post[:151],
                            use_kernel=True)
    finally:
        stdp_ops.stdp_update = real_upd
    args, kw = step_args[150]
    cases["stdp"].append(Case("stdp_step, step 150 of stdp_run", args, kw=kw,
                              path="stdp_step", timed=True))
    for B, M, N in ((8, 256, 256), (16, 300, 200), (4, 128, 640)):
        w = (0.5 * torch.randn((M, N), generator=g)).to(DEV)
        tr = [torch.rand((B, M), generator=g),
              (torch.rand((B, N), generator=g) < 0.2).float(),
              (torch.rand((B, M), generator=g) < 0.2).float(),
              torch.rand((B, N), generator=g)]
        for dt in (torch.float32, torch.bfloat16):
            cases["stdp"].append(Case(
                f"JAX test ({B}, {M}, {N}), {str(dt)[6:]}",
                tuple(t.to(dt).to(DEV) for t in tr) + (w,),
                kw=dict(a_plus=0.05, a_minus=0.06, w_min=-0.4, w_max=0.4),
                timed=True))
    cases["stdp"] += stdp_edge_cases()
    return cases


def stdp_step_inputs():
    """`bench_plasticity.measure_rule_only`'s shapes (T=300, B=8,
    256 x 128): Bernoulli(0.15) pre and post trains and 0.3 * normal
    weights from numpy's generator with seed 3, on the card."""
    rng = np.random.default_rng(3)
    pre = (rng.random((PLASTIC_T, PLASTIC_B, PLASTIC_IN)) < PLASTIC_RATE)
    post = (rng.random((PLASTIC_T, PLASTIC_B, PLASTIC_HIDDEN))
            < PLASTIC_RATE)
    w = 0.3 * rng.standard_normal((PLASTIC_IN, PLASTIC_HIDDEN))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(DEV)
                 for a in (pre, post, w))


def work(name, args, out, kw=None):
    """(bytes moved, fp32 operations on this run's data, the operations of
    the dense products) of one call with inputs `args` and outputs `out`.

    spikemm: each nonzero spike adds one row of w into its output row, so
    the product needs 2 * nnz * N operations (one multiply-add per term;
    an add alone takes the same issue slot at the fp32 peak), whatever
    blocking a kernel chooses; dense 2 * M * K * N. spikemm_sparse is the
    same function and counts the same operations; its bytes are the
    raster, the weight rows of the occupied block columns and the output.
    spikemm_gather: each nonzero spike at pre adds that neuron's fan-out
    (the nonzero weights of its row) into its output row,
    2 * sum_pre nnz(s[:, pre]) * fan-out(pre); its bytes are the nonzero
    weights the events need (those of every pre neuron that spikes in
    some row of the call), the raster and the output; dense
    2 * M * n_pre * n_post. (`gather_read_bytes` counts the patch rows
    the kernel reads instead, bn weights a listed row, and
    `gather_patch_bytes` every active patch, as a kernel that walks every
    term reads them.) The recurrent kernels add one W_rec row per
    spike of the previous step, 2 * nnz(s_{t-1}) * N (s_{-1} = s0),
    against the dense 2 * T * B * N * N; their backward the dense adjoint
    Gu_{t+1} W^T (Gu has no zeros to skip) and g_s0, 2 * (T + 1) * B * N
    * N. stdp_seq: a term's product needs
    2 * min(nnz(P_k) * N, nnz(Q_k) * M) operations (the sparser side's
    nonzeros each add one row), plus 2 * T * M * N for the step sums and
    the clip; dense 2 * K * T * B * M * N. stdp: 2 * (nnz(s_post) * M +
    nnz(s_pre) * N) for its two products, plus 3 * M * N; dense
    4 * B * M * N + 3 * M * N. The session axis counts as its unbatched
    kernel does over all sessions: `spikemm_sessions` the raster, every
    session's weight and the output once and 2 * nnz * N;
    `stdp_seq_sessions` every weight read and written once, the planes
    once, and stdp_seq's operations with the step sums of S weights.
    B6 (`spikemm_gather_bwd`) is the gather's function on the transposed
    tables (the caller passes those)."""
    tensors = [a for a in args if torch.is_tensor(a)]
    if name == "stdp_seq_sessions":
        P, Q, w = args
        K, TS, M = P.shape
        S, _, N = w.shape
        ops = 2 * sum(min(int(torch.count_nonzero(P[k])) * N,
                          int(torch.count_nonzero(Q[k])) * M)
                      for k in range(K)) + 2 * TS * M * N
        return (4 * (2 * S * M * N + K * TS * (M + N)), ops,
                2 * K * TS * M * N)
    if name == "spikemm_sessions":
        s, w = args
        T, S, K = s.shape
        N = w.shape[2]
        nnz = int(torch.count_nonzero(s))
        return (4 * (T * S * K + S * K * N + T * S * N), 2 * nnz * N,
                2 * T * S * K * N)
    if name == "stdp_seq":
        P, Q, w = args
        K, TB, M = P.shape
        N = w.shape[1]
        T = TB // kw["batch"]
        ops = 2 * sum(min(int(torch.count_nonzero(P[k])) * N,
                          int(torch.count_nonzero(Q[k])) * M)
                      for k in range(K)) + 2 * T * M * N
        return (4 * (2 * M * N + K * TB * (M + N)), ops,
                2 * K * TB * M * N)
    if name == "stdp":
        x_pre, s_post, s_pre, x_post, w = args
        B, M = x_pre.shape
        N = w.shape[1]
        ops = 2 * (int(torch.count_nonzero(s_post)) * M
                   + int(torch.count_nonzero(s_pre)) * N) + 3 * M * N
        return (4 * 2 * M * N + x_pre.element_size() * 2 * B * (M + N), ops,
                4 * B * M * N + 3 * M * N)
    if name == "spikemm":
        s, w = args
        M, K = s.shape
        N = w.shape[1]
        nnz = int(torch.count_nonzero(s))
        return 4 * (M * K + K * N + M * N), 2 * nnz * N, 2 * M * K * N
    if name == "spikemm_wgrad":
        R, K, N = wgrad_shape(args)
        nnz = int(torch.count_nonzero(wgrad_raster(args, kw)))
        return 4 * (R * K + R * N + K * N), 2 * nnz * N, 2 * R * K * N
    if name == "spikemm_sparse":
        from repro_torch.kernels.spikemm.sparse import (SPARSE_BLOCK,
                                                        occupancy_flags)
        s, w = args
        M, K = s.shape
        N = w.shape[1]
        cols = int((occupancy_flags(s) != 0).any(dim=0).sum())
        w_rows = min(K, cols * SPARSE_BLOCK[1])
        nnz = int(torch.count_nonzero(s))
        return (4 * (M * K + w_rows * N + M * N), 2 * nnz * N,
                2 * M * K * N)
    if name == "spikemm_gather":
        s, t = args
        M = s.shape[0]
        hits, fan = gather_rows_met(s, t)
        ops = 2 * int((hits * fan).sum())
        nnz = int((fan * (hits > 0)).sum())
        return (4 * (nnz + M * t.n_pre + M * t.n_post), ops,
                2 * M * t.n_pre * t.n_post)
    if name == "linrec":
        a, x, h0 = args
        a_bytes = 4 * int(np.prod([n for n, st in zip(a.shape, a.stride())
                                   if st != 0]))
        ops = 2 * x.numel()
        return a_bytes + 4 * (2 * x.numel() + 2 * h0.numel()), ops, ops
    if name == "linrec_bwd":
        # reads gy (the branches': the soma's (T, B, N)), g_hT where given
        # and a (its compact storage); writes gx; g_a also reads y and h0
        # and writes g_a, summed in the decay's shape or a plane; g_h0
        # writes (B, D)
        from repro_torch.kernels.linrec.ref import lanes_decay
        a, y, h0, gy, ghT = args
        need_a, need_h0 = kw.get("need_a", True), kw.get("need_h0", True)
        a_bytes = 4 * int(np.prod([n for n, st in zip(a.shape, a.stride())
                                   if st != 0]))
        n, m = y.numel(), h0.numel()
        summed = need_a and lanes_decay(a, y.shape[2])
        nbytes = (a_bytes + 4 * (gy.numel() + (0 if ghT is None else m) + n)
                  + (4 * (n + m + (a.numel() if summed else n))
                     if need_a else 0) + 4 * m * need_h0)
        ops = 2 * n + (2 * n if summed else n) * need_a + m * need_h0
        return nbytes, ops, ops
    T, B, N = args[0].shape
    nbytes = 4 * (sum(t.numel() for t in tensors)
                  + sum(o.numel() for o in out if o is not None))
    ops = LANE_OPS[name] * T * B * N
    if name in ("lifrec", "alifrec"):
        s0 = args[4] if name == "lifrec" else args[6]
        nnz = int(torch.count_nonzero(s0)) + int(torch.count_nonzero(
            out[0][:-1]))
        return nbytes, ops + 2 * nnz * N, ops + 2 * T * B * N * N
    if name in ("lifrec_bwd", "alifrec_bwd"):
        # the recurrent adjoint: Gu_{t+1} (dense) times W^T, N terms a
        # neuron a step, and g_s0 = Gu_0 W^T
        dense = ops + 2 * (T + 1) * B * N * N
        return nbytes, dense, dense
    return nbytes, ops, ops


def wgrad_shape(args):
    """(R, K, N) of a `spikemm_wgrad` call on (spikes, g)."""
    return args[1].shape[0], args[0].shape[1], args[1].shape[1]


def wgrad_raster(args, kw):
    """The (R, K) raster of a `spikemm_wgrad` call, its `head` rows first."""
    from repro_torch.kernels.spikemm.ref import shifted_raster
    return shifted_raster(args[0], args[1].shape[0], kw.get("head"))


def gather_rows_met(s, t):
    """For each patch row of the gather tables `t`, (E, bk) each: the rows
    of the raster `s` in which its pre neuron spikes, and its nonzero
    weights (0 on sentinels)."""
    d = t.device(s.device)
    kb = -(-t.n_pre // t.bk)
    col = torch.zeros(kb * t.bk, dtype=torch.int64, device=s.device)
    col[:t.n_pre] = torch.count_nonzero(s, dim=0)
    pre = d.kk.long()[:, None] * t.bk + torch.arange(t.bk, device=s.device)
    fan = torch.count_nonzero(d.wblk, dim=2) * (d.act != 0)[:, None]
    return col[pre], fan


def gather_read_bytes(s, t):
    """The gather's bytes as `csrc/spikemm_gather.cu` reads them: bn
    weights of every patch row that holds a nonzero weight and meets a
    spike of the call, the raster and the output; printed beside `work`'s
    (a bound of this design's reads, not of the function)."""
    hits, fan = gather_rows_met(s, t)
    rows = int(((fan > 0) & (hits > 0)).sum())
    return 4 * (rows * t.bn + s.shape[0] * t.n_pre + s.shape[0] * t.n_post)


def gather_patch_bytes(s, t):
    """The gather's bytes if every active patch is read (a kernel that
    walks every term), printed beside `work`'s."""
    return 4 * (t.n_entries * t.bk * t.bn + s.shape[0] * t.n_pre
                + s.shape[0] * t.n_post)


@dataclasses.dataclass
class Case:
    """One call of a kernel in the kernel phase. `path` names the path
    whose main run makes this call (its row in the kernel table sums the
    calls of the kernel's HOME path); `timed` cases are timed whatever
    their path; `library` is one PyTorch call of the same function."""
    label: str
    args: tuple
    path: str = None
    timed: bool = False
    library: Callable = None
    dense_w: torch.Tensor = None     # gather: also held against spikemm
    build_s: float = None            # gather: seconds to build its tables
    rows_alone: bool = False         # gather: each row alone == its batch row
    silent: bool = False             # the output must be +0 everywhere
    kw: dict = dataclasses.field(default_factory=dict)  # keyword arguments
    plain_iters: int = None          # timed calls of a slow plain version
    rtol: float = None               # spikemm: against the plain matmul
    atol: float = None               # lif_bwd under sigmoid: with rtol
    zero_ok: bool = False            # outputs may be all zero (T = 0)


def packed_raster(M, K, density, seed, rate=0.5):
    """`spikemm/sparse.py::_packed_raster` with numpy: population-packed
    activity filling a dense corner (the mapping pass's channel order), so
    block occupancy tracks density instead of being defeated by it."""
    f = min(1.0, float(density / rate) ** 0.5)
    m_act, k_act = max(1, int(M * f)), max(1, int(K * f))
    x = np.zeros((M, K), np.float32)
    x[:m_act, :k_act] = np.random.default_rng(seed).random(
        (m_act, k_act)) < rate
    return x


def banded(n, band, w=None, seed=0):
    """`bench_topology_exec`'s banded connectivity: each neuron reaches its
    +-band neighbours, weight `w` or 0.1 * normal from `seed`, encoded
    `sparse_coo`."""
    from repro_torch.core import topology as topo
    rows = np.repeat(np.arange(n), 2 * band + 1)
    cols = rows + np.tile(np.arange(-band, band + 1), n)
    keep = (cols >= 0) & (cols < n)
    if w is None:
        wv = 0.1 * np.random.default_rng(seed).standard_normal(
            keep.sum()).astype(np.float32)
    else:
        wv = w * np.ones(keep.sum(), np.float32)
    return topo.encode((rows[keep], cols[keep], wv), kind="sparse_coo",
                       n_pre=n, n_post=n)


def csr_product(enc, transpose=False):
    """A function of s computing s @ W (s @ W^T where `transpose`: the
    gather's backward) with one `torch.sparse.mm` for the topology `enc`,
    W^T (W) held as a CSR matrix on the card (built once): the library
    yardstick where the dense matrix does not fit."""
    pre, post, w = enc.coo()
    rows, cols, shape = ((pre, post, (enc.n_pre, enc.n_post)) if transpose
                         else (post, pre, (enc.n_post, enc.n_pre)))
    wt = torch.sparse_coo_tensor(
        torch.from_numpy(np.stack([rows, cols])), torch.from_numpy(w),
        shape).coalesce().to_sparse_csr().to(DEV)

    def product(s):
        st = s.t().contiguous()
        return lambda: torch.sparse.mm(wt, st)
    return product


def sparse_parts(s, w):
    """The sparse channel's two launches on (s, w), each a call of its
    own: the occupancy kernel alone, and the product alone on flags
    measured once here."""
    from repro_torch.kernels.spikemm.sparse import (occupancy_cuda,
                                                    spikemm_sparse_cuda)
    flags, _ = occupancy_cuda(s)
    return (lambda: occupancy_cuda(s),
            lambda: spikemm_sparse_cuda(s, w, flags))


def check_occupancy(label, s):
    """The occupancy kernel's flags equal `block_occupancy` at
    SPARSE_BLOCK exactly, and its total their sum."""
    from repro_torch.kernels.spikemm.sparse import (SPARSE_BLOCK,
                                                    block_occupancy,
                                                    occupancy_cuda)
    flags, total = occupancy_cuda(s)
    want = block_occupancy(s, *SPARSE_BLOCK)
    if not torch.equal(flags, want):
        raise AssertionError(f"spikemm_sparse [{label}]: occupancy flags "
                             f"differ from block_occupancy in "
                             f"{int((flags != want).sum())} blocks")
    if int(total) != int(want.sum()):
        raise AssertionError(f"spikemm_sparse [{label}]: total {int(total)}"
                             f", block_occupancy counts {int(want.sum())}")
    return int(total), want.numel()


def sparse_sync_checks(s, w, s_dense, w_dense):
    """No host sync in the sparse channel, one in `auto`'s dispatch.

    Under `torch.cuda.set_sync_debug_mode("error")` the channel runs with
    and without flags handed in; under "warn", one `spikemm` dispatch in
    `auto` gives exactly one sync warning, on a raster it routes sparse
    (s, w) and on one it routes dense (s_dense, w_dense)."""
    import warnings

    from repro_torch.kernels.spikemm.ops import spikemm
    from repro_torch.kernels.spikemm.sparse import (occupancy_cuda,
                                                    spikemm_sparse_cuda)
    env = "REPRO_SPIKEMM_SPARSE"
    flags, _ = occupancy_cuda(s)
    spikemm_sparse_cuda(s, w)                         # warm: build, sm count
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        spikemm_sparse_cuda(s, w)
        spikemm_sparse_cuda(s, w, flags)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    saved = os.environ.pop(env, None)
    warned = []
    try:
        for x, y in ((s, w), (s_dense, w_dense)):
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    spikemm(x, y)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            warned.append(sum("synchroniz" in str(r.message) for r in rec))
    finally:
        if saved is not None:
            os.environ[env] = saved
    sync()
    if warned != [1, 1]:
        raise AssertionError(f"spikemm_sparse: auto dispatches gave {warned} "
                             "sync warnings (sparse route, dense route); "
                             "each should give one")
    log("kernel spikemm_sparse: the channel runs under "
        "set_sync_debug_mode('error') with and without flags; one auto "
        "dispatch gives one sync warning on a sparse-routed raster and one "
        "on a dense-routed one")


def wgrad_sync_checks(cases):
    """g_w under `auto` takes no host read and measures no occupancy: each
    training g_w call of `spikemm_wgrad`'s cases through `spikemm_g_w`
    (the backward's route) under `torch.cuda.set_sync_debug_mode("error")`
    launches the weight-gradient kernel once and the occupancy kernel
    never, and equals the kernel called alone bit for bit."""
    from repro_torch.kernels.spikemm.ops import (spikemm_g_w,
                                                 spikemm_wgrad_cuda)
    from repro_torch.kernels.spikemm.sparse import occupancy_cuda
    env = "REPRO_SPIKEMM_SPARSE"
    saved = os.environ.pop(env, None)
    n = 0
    try:
        for c in cases:
            if not c.path:
                continue
            want = spikemm_wgrad_cuda(*c.args, **c.kw)
            sync()
            occ0, k0 = occupancy_cuda.launches, spikemm_wgrad_cuda.launches
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = spikemm_g_w(*c.args, **c.kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            sync()
            moved = (occupancy_cuda.launches - occ0,
                     spikemm_wgrad_cuda.launches - k0)
            if moved != (0, 1) or not torch.equal(got, want):
                raise AssertionError(
                    f"spikemm_wgrad [{c.label}]: under auto, g_w launched "
                    f"{moved} (occupancy, weight gradient), want (0, 1), "
                    f"equal {torch.equal(got, want)}")
            n += 1
    finally:
        if saved is not None:
            os.environ[env] = saved
    log(f"kernel spikemm_wgrad: {n} training g_w calls under auto, each one "
        "weight-gradient launch, no occupancy launch, under "
        "set_sync_debug_mode('error')")


def gather_edge_tables(bk, bn, seed):
    """Gather tables of a ragged topology (GATHER_EDGE_SHAPE at 8 %
    density) whose posts from GATHER_EDGE_NO_FAN_IN on have no fan-in, so
    that its last post blocks are made only of sentinels at every block
    shape; after packing, about 5 % of the patch rows become all -0.0,
    5 % all +0.0, and some zero weights -0.0."""
    from repro_torch.kernels.spikemm.gather import build_gather_tables
    rng = np.random.default_rng(seed)
    n_pre, n_post = GATHER_EDGE_SHAPE
    mask = rng.random((n_pre, n_post)) < 0.08
    mask[:, GATHER_EDGE_NO_FAN_IN:] = False
    pre, post = np.nonzero(mask)
    w = rng.standard_normal(len(pre)).astype(np.float32)
    t = build_gather_tables(pre, post, w, n_pre, n_post, bk=bk, bn=bn)
    pick = rng.random(t.wblk.shape[:2])
    t.wblk[pick < 0.05] = -0.0
    t.wblk[(pick >= 0.05) & (pick < 0.1)] = 0.0
    t.wblk[(t.wblk == 0) & (rng.random(t.wblk.shape) < 0.02)] = -0.0
    return t


def graded_raster(M, n, seed, rate=0.3):
    """(M, n) graded spikes of either sign at `rate`, some zeros -0.0, and
    (for M > 1) row M // 2 silent."""
    rng = np.random.default_rng(seed)
    x = np.where(rng.random((M, n)) < rate,
                 rng.uniform(0.25, 2.0, (M, n)) * rng.choice([-1, 1], (M, n)),
                 0.0).astype(np.float32)
    x[(x == 0) & (rng.random((M, n)) < 0.05)] = -0.0
    if M > 1:
        x[M // 2] = 0.0
    return x


def gather_cases():
    """The gather kernel's cases: the banded path's chunk, the topology
    benchmark's rows (scale_1e5 and scale_1e6 at each of GATHER_M rows),
    the six ragged encodings of the JAX tests, and edge cases at each of
    GATHER_EDGE_BLOCKS x GATHER_EDGE_M (graded spikes with -0.0, a silent
    row, -0.0 and +0.0 patch rows, sentinel post blocks), an all-silent
    raster and one where only the last pre neuron of each block fires."""
    from repro_torch.core import topology as topo
    s = torch.from_numpy(banded_input()[:BANDED_CHUNK].reshape(
        BANDED_CHUNK, BANDED_N)).to(DEV)
    wd = torch.from_numpy(banded_net().dense_equivalent()).to(DEV)
    cases = [Case(f"topology_banded chunk (T={BANDED_CHUNK}, B=1)",
                  (s, banded_net().lowering()), path="topology_banded",
                  timed=True, library=lambda s=s, wd=wd: torch.matmul(s, wd))]
    n, band, bk, m, rate = GATHER_ROWS["exec_vs_dense"]
    enc = banded(n, band, seed=0)
    s = torch.from_numpy((np.random.default_rng(1).random((m, n)) < rate
                          ).astype(np.float32)).to(DEV)
    wd = torch.from_numpy(enc.dense_equivalent()).to(DEV)
    cases.append(Case(f"exec_vs_dense n={n} band {band}",
                      (s, enc.lowering(bk=bk, bn=bk)), timed=True,
                      library=lambda s=s, wd=wd: torch.matmul(s, wd),
                      dense_w=wd))
    for label in ("scale_1e5", "scale_1e6"):
        n, band, bk, m_home, rate = GATHER_ROWS[label]
        t0 = time.perf_counter()
        enc = banded(n, band, seed=0)
        tables = enc.lowering(bk=bk, bn=bk)
        build = time.perf_counter() - t0
        csr = csr_product(enc)
        for m in GATHER_M:
            x = torch.from_numpy((np.random.default_rng(2).random((m, n))
                                  < rate).astype(np.float32)).to(DEV)
            cases.append(Case(
                f"{label} n={n} band {band} bk=bn={bk}, M={m}", (x, tables),
                timed=True, library=csr(x), build_s=build,
                rows_alone=label == "scale_1e6" and m == m_home))
    rng = np.random.default_rng(3)
    dense = rng.standard_normal((37, 29)).astype(np.float32) * 0.3
    sp = dense * (rng.random((37, 29)) < 0.15)
    filt = 0.4 * rng.standard_normal((3, 2, 3, 3)).astype(np.float32)
    pre, post = np.nonzero(rng.random((45, 33)) < 0.08)
    w = 0.5 * rng.standard_normal(len(pre)).astype(np.float32)
    for label, e in (
            ("sparse_t0", topo.encode(sp, kind="sparse", ie_type=0)),
            ("sparse_t1", topo.encode(sp, kind="sparse", ie_type=1)),
            ("sparse_coo_t1", topo.encode((pre, post, w), kind="sparse_coo",
                                          n_pre=45, n_post=33)),
            ("conv_t3", topo.encode(filt, kind="conv", h=6, w=5)),
            ("pool_t0", topo.encode(None, kind="pool", h=6, w=6, c=2, k=2)),
            ("sparse_t1 at bk=8, bn=4", topo.encode(sp, kind="sparse",
                                                    ie_type=1))):
        tables = e.lowering(8, 4) if "bk=8" in label else e.lowering()
        s = torch.from_numpy((rng.random((9, e.n_pre)) < 0.35).astype(
            np.float32)).to(DEV)
        cases.append(Case(f"ragged {label}", (s, tables)))
    n_pre = GATHER_EDGE_SHAPE[0]
    for i, (bk, bn) in enumerate(GATHER_EDGE_BLOCKS):
        tables = gather_edge_tables(bk, bn, seed=10 + i)
        tag = f"edge bk={bk} bn={bn}"
        for m in GATHER_EDGE_M:
            x = graded_raster(m, n_pre, seed=20 + 7 * i + m)
            cases.append(Case(f"{tag}, graded M={m}",
                              (torch.from_numpy(x).to(DEV), tables)))
        last = np.zeros((9, n_pre), np.float32)
        last[:, bk - 1::bk] = 1.0
        last[:, n_pre - 1] = 1.0
        cases.append(Case(f"{tag}, last pre neuron of each block fires, M=9",
                          (torch.from_numpy(last).to(DEV), tables)))
        cases.append(Case(f"{tag}, all silent, M=9",
                          (torch.zeros((9, n_pre), device=DEV), tables),
                          silent=True))
    return cases


def gather_bwd_cases():
    """B6's cases: the gather's backward, d_spikes = g @ W^T, the kernel on
    the transposed tables of topology_banded's band and of scale_1e5, at
    train_banded's backward rows (T x B = 1024) and at 64 rows, each on a
    dense graded g (a cotangent has no zeros to skip), timed beside one
    CSR `torch.sparse.mm` of W."""
    out = []
    for label, enc, bk in (("topology_banded", banded_net(), None),
                           ("scale_1e5", banded(*GATHER_ROWS["scale_1e5"][:2],
                                               seed=0),
                            GATHER_ROWS["scale_1e5"][2])):
        tables = enc.lowering(bk=bk, bn=bk)
        csr = csr_product(enc, transpose=True)
        for m in (BANDED_TRAIN_T * BANDED_TRAIN_B, 64):
            g = torch.randn((m, enc.n_post), generator=torch.Generator()
                            .manual_seed(m)).to(DEV)
            out.append(Case(f"{label} transposed tables, dense g, M={m}",
                            (g, tables), timed=True, library=csr(g)))
    return out


def session_cases():
    """{kernel: [Case]} of the session axis at serve_plastic's window
    (WINDOW steps, PLASTIC_IN -> PLASTIC_HIDDEN): `spikemm_sessions` (the
    plastic INTEG, (32, S, 256) @ (S, 256, 128)) and `stdp_seq_sessions`
    (the pair rule's two term planes; the triplet rule's four), captured
    at plan's calls in one learning `plan.run` of S sessions stacked as the
    serve engine stacks them, each on its own weight (the seed's plus 0.05
    x normal), at S = 1, 7 and CAPACITY; the pair rule's full cohort is the
    path's home call. `spikemm_sessions` is timed beside `torch.bmm` (a
    yardstick; the port never calls it)."""
    from repro_torch.core import events, plan, plasticity
    from repro_torch.serve.engine import _stack_sessions
    out = {"spikemm_sessions": [], "stdp_seq_sessions": []}
    real = (plan.spikemm_sessions, plan.stdp_seq_sessions)
    got = []

    def spy_mm(s, w):
        got.append(("spikemm_sessions", (s, w), {}))
        return real[0](s, w)

    def spy_seq(P, Q, w, **kw):
        got.append(("stdp_seq_sessions", (P, Q, w), kw))
        return real[1](P, Q, w, **kw)

    plan.spikemm_sessions, plan.stdp_seq_sessions = spy_mm, spy_seq
    try:
        for rule_name, S in ([("pair_stdp", n) for n in SESSION_S]
                             + [("triplet_stdp", CAPACITY)]):
            nodes, params = make_plastic(rule_name, DEV)
            gen = torch.Generator().manual_seed(S)
            states = []
            for _ in range(S):
                st = events.init_state(nodes, 1, torch.float32, params,
                                       device=DEV)
                syn = st["hidden"]["syn:input"]
                syn["w"] = syn["w"] + 0.05 * torch.randn(
                    syn["w"].shape, generator=gen).to(DEV)
                states.append(st)
            stacked = _stack_sessions(states)
            x = torch.from_numpy((np.random.default_rng(S).random(
                (WINDOW, S, PLASTIC_IN)) < PLASTIC_RATE).astype(
                    np.float32)).to(DEV)
            del got[:]
            with torch.no_grad():
                plan.run(nodes, plasticity.apply_learned(nodes, params,
                                                         stacked),
                         x, state=stacked, device=DEV, _traced=True)
            home = rule_name == "pair_stdp" and S == CAPACITY
            for name, args, kw in got:
                out[name].append(Case(
                    f"serve_plastic window, {rule_name}, S={S}"
                    + (f", K={args[0].shape[0]}" if name ==
                       "stdp_seq_sessions" else ""), args, kw=kw,
                    path="serve_plastic" if home else None, timed=True,
                    library=(lambda a=args: torch.bmm(a[0].transpose(0, 1),
                                                      a[1]))
                    if name == "spikemm_sessions" else None,
                    plain_iters=2 if name == "stdp_seq_sessions" else None))
    finally:
        plan.spikemm_sessions, plan.stdp_seq_sessions = real
    return out


def sparse_cases():
    """The sparse channel's cases: the sparse_integ path's hidden INTEG at
    the density whose run the kernel table records and at density 0.01,
    and its readout INTEG at 0.01 (the calls `auto` routes sparse there),
    `bench_kernels`' SPARSITY_SHAPE at its four densities, an all-silent,
    an all-occupied and a partly graded raster at the hidden INTEG's
    shape, a raster of
    128 k blocks whose occupied ones span three ballot words of a CTA's
    list, one of more k blocks than a CTA lists at once, and two ragged
    shapes."""
    from repro_torch.core import plan
    from repro_torch.kernels.spikemm.sparse import SPARSE_BLOCK
    g = torch.Generator().manual_seed(4)
    nodes, params = make_sparse_integ(DEV)
    w_in = params["hidden"]["w_input"]
    M, K = SPARSE_T * SPARSE_B, SPARSE_IN
    s = torch.from_numpy(packed_raster(M, K, SPARSE_HOME_DENSITY,
                                       SPARSE_SEED)).to(DEV)
    cases = [Case(SPARSE_HOME_CASE, (s, w_in), path="sparse_integ",
                  timed=True)]
    x = torch.from_numpy(packed_raster(M, K, SPARSE_DENSITIES[0],
                                       SPARSE_SEED)).to(DEV)
    cases.append(Case(f"sparse_integ hidden INTEG, density "
                      f"{SPARSE_DENSITIES[0]}", (x, w_in), timed=True))
    _, _, rec = plan.run(nodes, params, x.reshape(SPARSE_T, SPARSE_B, K),
                         record=("hidden",), device=DEV)
    cases.append(Case(f"sparse_integ readout INTEG, density "
                      f"{SPARSE_DENSITIES[0]}",
                      (rec["hidden"].reshape(M, -1).contiguous(),
                       params["readout"]["w_hidden"]), timed=True))
    cases.append(Case("all-silent raster at the hidden INTEG's shape",
                      (torch.zeros((M, K), device=DEV), w_in), timed=True,
                      silent=True))
    # one spike in every (bm, bk) block, at a place drawn from seed 7
    bm, bk = SPARSE_BLOCK
    rng = np.random.default_rng(7)
    full = np.zeros((M, K), np.float32)
    full[np.arange(0, M, bm)[:, None] + rng.integers(0, bm, (M // bm, 1)),
         np.arange(0, K, bk)[None, :] + rng.integers(0, bk, (1, K // bk))
         ] = 1.0
    cases.append(Case("all-occupied raster at the hidden INTEG's shape, "
                      "one spike a block", (torch.from_numpy(full).to(DEV),
                                            w_in), timed=True))
    # graded spikes (0.5, 2, -1) in the first 1000 k of the active
    # corner, 0/1 after: each term's fmaf rounds (a 0/1 spike's is exact)
    graded = packed_raster(M, K, SPARSE_HOME_DENSITY, SPARSE_SEED)
    graded[:, :1000] *= np.random.default_rng(10).choice(
        np.array([0.5, 2.0, -1.0], np.float32), (M, 1000))
    cases.append(Case("graded spikes (0.5, 2, -1) in k < 1000, 0/1 after, "
                      "at the hidden INTEG's shape",
                      (torch.from_numpy(graded).to(DEV), w_in), timed=True))
    # packed at 2 %, its active corner 81 of 128 k blocks wide
    s = torch.from_numpy(packed_raster(128, 8192, 0.02, 8, rate=0.05))
    cases.append(Case("128x8192x64, packed at 0.02 (81 of 128 k blocks)",
                      (s.to(DEV), torch.randn((8192, 64), generator=g)
                       .to(DEV)), timed=True))
    M, K, N = SPARSITY_SHAPE
    w = torch.randn((K, N), generator=g).to(DEV)
    for d in SPARSE_DENSITIES:
        s = torch.from_numpy(packed_raster(M, K, d, 2)).to(DEV)
        cases.append(Case(f"bench_kernels {M}x{K}x{N}, density {d}", (s, w),
                          timed=True))
    # Bernoulli(0.001): 1032 k blocks a row block, about 2 % of them silent
    s = np.random.default_rng(9).random((96, 66000)) < 0.001
    cases.append(Case("96x66000x24, Bernoulli(0.001) (1032 k blocks)",
                      (torch.from_numpy(s.astype(np.float32)).to(DEV),
                       torch.randn((66000, 24), generator=g).to(DEV))))
    for M, K, N in ((100, 300, 200), (130, 700, 64)):
        s = torch.from_numpy(packed_raster(M, K, 0.05, M)).to(DEV)
        cases.append(Case(f"ragged {M}x{K}x{N}, density 0.05",
                          (s, torch.randn((K, N), generator=g).to(DEV))))
    return cases


def spikemm_cases():
    """spikemm beyond the serving windows: the parity harness's inputs
    (`_make_inputs`, (100, 300) @ (300, 200)); the sparse_integ path's
    hidden INTEG, (2048, 4096) @ (4096, 512), at each of its densities
    (what its dense channel meets); and the topology_banded path's readout
    INTEG on one chunk's hidden spikes, (64, 8192) @ (8192, 8). The last
    two are timed beside `torch.matmul`."""
    from repro_torch.core import plan
    from repro_torch.kernels import registry
    s, w = registry.get("spikemm").make_inputs(torch.Generator().manual_seed(0))
    cases = [Case("parity inputs (make_inputs)", (s.to(DEV), w.to(DEV)))]
    _, params = make_sparse_integ(DEV)
    w = params["hidden"]["w_input"]
    for d in SPARSE_DENSITIES:
        s = torch.from_numpy(packed_raster(SPARSE_T * SPARSE_B, SPARSE_IN, d,
                                           SPARSE_SEED)).to(DEV)
        cases.append(Case(f"sparse_integ hidden INTEG, density {d}", (s, w),
                          timed=True))
    nodes, params = make_banded(DEV)
    x = torch.from_numpy(banded_input()[:BANDED_CHUNK]).to(DEV)
    _, _, rec = plan.run(nodes, params, x, record=("hidden",), device=DEV)
    # ~8000 spikes at 0.1 sum to |out| ~ 800: against the plain matmul's
    # other sum order it is held relative to its size, as the path's
    # readout is (and bit for bit against spikemm_chain_ref)
    cases.append(Case("topology_banded readout INTEG, one chunk",
                      (rec["hidden"].reshape(BANDED_CHUNK, BANDED_N)
                       .contiguous(), params["readout"]["w_hidden"]),
                      timed=True, rtol=BANDED_READOUT_RTOL))
    return [dataclasses.replace(c, library=lambda a=c.args: torch.matmul(*a))
            if c.timed else c for c in cases]


def kernel_impls():
    """({kernel: CUDA wrapper}, {kernel: plain version})."""
    from repro_torch.kernels.alifrec.ops import (alif_bwd_cuda, alif_cuda,
                                                 alif_scan_bwd_ref,
                                                 alif_scan_ref,
                                                 alifrec_bwd_cuda,
                                                 alifrec_cuda,
                                                 alifrec_scan_bwd_ref,
                                                 alifrec_scan_ref)
    from repro_torch.kernels.lif.ops import (lif_bwd_cuda, lif_cuda,
                                             lif_scan_bwd_ref, lif_scan_ref)
    from repro_torch.kernels.lifrec.ops import (lifrec_bwd_cuda, lifrec_cuda,
                                                lifrec_scan_bwd_ref,
                                                lifrec_scan_ref)
    from repro_torch.kernels.linrec.ops import (linrec_bwd_cuda,
                                                linrec_bwd_ref, linrec_cuda,
                                                linrec_ref)
    from repro_torch.kernels.spikemm.gather import (spikemm_gather_bwd_cuda,
                                                    spikemm_gather_bwd_ref,
                                                    spikemm_gather_cuda,
                                                    spikemm_gather_ref)
    from repro_torch.kernels.spikemm.ops import (spikemm_cuda, spikemm_ref,
                                                 spikemm_sessions_cuda,
                                                 spikemm_sessions_ref,
                                                 spikemm_wgrad_cuda,
                                                 spikemm_wgrad_ref)
    from repro_torch.kernels.spikemm.sparse import (spikemm_sparse_cuda,
                                                    spikemm_sparse_ref)
    from repro_torch.kernels.stdp.ops import (stdp_seq_cuda, stdp_seq_ref,
                                              stdp_seq_sessions_cuda,
                                              stdp_seq_sessions_ref,
                                              stdp_update_cuda,
                                              stdp_update_ref)
    cuda = {"spikemm": spikemm_cuda, "linrec": linrec_cuda, "lif": lif_cuda,
            "lifrec": lifrec_cuda, "alif": alif_cuda,
            "alifrec": alifrec_cuda, "spikemm_sparse": spikemm_sparse_cuda,
            "spikemm_gather": spikemm_gather_cuda, "stdp_seq": stdp_seq_cuda,
            "stdp": stdp_update_cuda, "lif_bwd": lif_bwd_cuda,
            "linrec_bwd": linrec_bwd_cuda, "lifrec_bwd": lifrec_bwd_cuda,
            "alif_bwd": alif_bwd_cuda, "alifrec_bwd": alifrec_bwd_cuda,
            "spikemm_wgrad": spikemm_wgrad_cuda,
            "spikemm_gather_bwd": spikemm_gather_bwd_cuda,
            "spikemm_sessions": spikemm_sessions_cuda,
            "stdp_seq_sessions": stdp_seq_sessions_cuda}
    plain = {"spikemm": spikemm_ref, "linrec": linrec_ref,
             "lif": lif_scan_ref, "lifrec": lifrec_scan_ref,
             "alif": alif_scan_ref, "alifrec": alifrec_scan_ref,
             "spikemm_sparse": spikemm_sparse_ref,
             "spikemm_gather": spikemm_gather_ref,
             "stdp_seq": stdp_seq_ref, "stdp": stdp_update_ref,
             "lif_bwd": lif_scan_bwd_ref, "linrec_bwd": linrec_bwd_ref,
             "lifrec_bwd": lifrec_scan_bwd_ref,
             "alif_bwd": alif_scan_bwd_ref,
             "alifrec_bwd": alifrec_scan_bwd_ref,
             "spikemm_wgrad": spikemm_wgrad_ref,
             "spikemm_gather_bwd": spikemm_gather_bwd_ref,
             "spikemm_sessions": spikemm_sessions_ref,
             "stdp_seq_sessions": stdp_seq_sessions_ref}
    return cuda, plain


def kernel_cases(shd_params):
    """{kernel: [Case]}: every kernel's calls of the kernel phase."""
    cases = {name: [] for name in kernel_impls()[0]}
    for path, window in (("shd", shd_window(shd_params)),
                         ("ecg", ecg_window(True)),
                         ("alif_ff", {"alif": [("ALIF-ff hidden",
                                                alif_ff_run_inputs())]})):
        for name, calls in window.items():
            if name in SERIAL:
                continue                       # in serial_cases
            cases[name] += [Case(label, args, path=path, timed=True,
                                 library=(lambda a=args: torch.matmul(*a))
                                 if name == "spikemm" else None)
                            for label, args in calls]
    for name, calls in ragged_cases().items():
        if name not in SERIAL:
            cases[name] += [Case(label, args) for label, args in calls]
    cases["spikemm"] += spikemm_cases()
    cases["linrec"] += plastic_linrec_cases() + linrec_edge_cases()
    cases["lif"] += path_lif_cases()
    for name, calls in lane_fire_edge_cases().items():
        cases[name] += calls
    cases["spikemm_sparse"] = [
        dataclasses.replace(c, library=lambda a=c.args: torch.matmul(*a))
        for c in sparse_cases()]
    cases["spikemm_gather"] = gather_cases()
    cases["spikemm_gather_bwd"] += gather_bwd_cases()
    for name, calls in session_cases().items():
        cases[name] += calls
    for name, calls in serial_cases().items():
        cases[name] += calls
    for name, calls in train_cases().items():
        cases[name] += calls
    for name, calls in bci_cases().items():
        cases[name] += calls
    return cases


def serial_cases():
    """{kernel: [Case]} of the serial-chain kernels: the ECG windows'
    hidden layers (`alifrec`; `lifrec` in the homogeneous ablation), the
    ragged and wide recurrent rows, both sides of the scan's route edges,
    and the learning kernels' cases."""
    cases = {name: [] for name in SERIAL}
    for path, name, heterogeneous in (("ecg", "alifrec", True),
                                      ("ecg_homogeneous", "lifrec", False)):
        cases[name] += [Case(label, args, path=path, timed=True)
                        for label, args in ecg_window(heterogeneous)[name]]
    ragged = ragged_cases()
    for name in ("lifrec", "alifrec"):
        cases[name] += [Case(label, args) for label, args in ragged[name]]
    for more in (wide_rec_cases(), rec_route_cases(), stdp_cases()):
        for name, calls in more.items():
            cases[name] += calls
    return cases


def phase_kernels(cases):
    from repro_torch.kernels.common import (rec_route,
                                            rec_route_launch_counts,
                                            w_in_smem)
    from repro_torch.kernels.spikemm.ops import spikemm_cuda
    from repro_torch.kernels.spikemm.ops import spikemm_sessions_chain_ref
    from repro_torch.kernels.spikemm.ref import (spikemm_chain_ref,
                                                 spikemm_wgrad_chain_ref)
    from repro_torch.kernels.spikemm.wgrad import wgrad_chunk, wgrad_chunks
    cuda, plain = kernel_impls()
    results = {}
    floor = launch_floor_ms()
    if "stdp_seq" in cases:
        stdp_seq_no_rows()
    for name, calls_in in cases.items():
        calls, max_err = [], 0.0
        for case in calls_in:
            label, args, kw = case.label, case.args, case.kw
            before = rec_route_launch_counts()
            got = cuda[name](*args, **kw)
            route = None
            if name in REC_KERNELS:
                # the route the wrapper took: one launch on rec_route(N)'s
                # counter and none on the other's (none at all for a call
                # with no steps, which launches nothing)
                route = rec_route(args[0].shape[2])
                took = {r: n - before[name][r]
                        for r, n in rec_route_launch_counts()[name].items()}
                launched = args[0].numel() > 0
                if took != {r: int(r == route and launched) for r in took}:
                    raise AssertionError(f"{name} [{label}]: route counters "
                                         f"moved {took}, planned {route}")
            ref = plain[name](*args, **kw)
            sync()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            extra = "" if route is None else (
                f", {route} route (its counter "
                f"{rec_route_launch_counts()[name][route]})")
            if name in BWD_SCANS:
                # a gradient not asked for is None, on both sides
                if [g is None for g in got] != [r is None for r in ref]:
                    raise AssertionError(f"{name} [{label}]: computed "
                                         "other gradients than its plain "
                                         "version")
                got = tuple(g for g in got if g is not None)
                ref = tuple(r for r in ref if r is not None)
            for g, r in zip(got, ref):
                if not torch.isfinite(g).all():
                    raise AssertionError(f"{name} [{label}]: non-finite")
                if case.silent:
                    if not torch.equal(g.view(torch.int32),
                                       torch.zeros_like(g, dtype=torch.int32)):
                        raise AssertionError(f"{name} [{label}]: a silent "
                                             "input gave an output not +0")
                elif not g.abs().sum() > 0 and not case.zero_ok:
                    raise AssertionError(f"{name} [{label}]: all zero, the "
                                         "comparison would be vacuous")
                err = float((g - r).abs().max()) if g.numel() else 0.0
                max_err = max(max_err, err)
                if name == "spikemm":
                    torch.testing.assert_close(g, r, rtol=case.rtol or
                                               SPIKEMM_TOL, atol=SPIKEMM_TOL)
                    # and bit for bit the kernel's fmaf chain (atol = 0)
                    chain = spikemm_chain_ref(*args)
                    if not torch.equal(g, chain):
                        raise AssertionError(
                            f"{name} [{label}]: differs from "
                            f"spikemm_chain_ref by "
                            f"{float((g - chain).abs().max()):.3e}")
                    extra = ", equal to spikemm_chain_ref bit for bit"
                elif name == "spikemm_wgrad":
                    torch.testing.assert_close(g, r, rtol=case.rtol or
                                               SPIKEMM_TOL, atol=SPIKEMM_TOL)
                    # and bit for bit its split chain (atol = 0)
                    R, K, N = wgrad_shape(args)
                    chain = spikemm_wgrad_chain_ref(
                        *args, wgrad_chunk(R, K, N), **kw)
                    if not torch.equal(g.view(torch.int32),
                                       chain.view(torch.int32)):
                        raise AssertionError(
                            f"{name} [{label}]: differs from "
                            f"spikemm_wgrad_chain_ref by "
                            f"{float((g - chain).abs().max()):.3e}")
                    extra = (f", {wgrad_chunks(R, K, N)} chunk(s) of "
                             f"{wgrad_chunk(R, K, N)} rows, equal to "
                             "spikemm_wgrad_chain_ref bit for bit")
                elif name == "spikemm_sparse":
                    torch.testing.assert_close(g, r, rtol=CHANNEL_TOL,
                                               atol=CHANNEL_TOL)
                    extra = (", bit for bit" if torch.equal(g, r)
                             else f", max abs err {err:.3e}")
                elif name in BWD_SCANS and case.rtol is not None:
                    # sigmoid: the kernel's expf against PyTorch's sigmoid
                    torch.testing.assert_close(g, r, rtol=case.rtol,
                                               atol=case.atol)
                    extra = (", bit for bit" if same_bits(name, g, r)
                             else f", max abs err {err:.3e}")
                elif name == "spikemm_sessions":
                    torch.testing.assert_close(g, r, rtol=SPIKEMM_TOL,
                                               atol=SPIKEMM_TOL)
                    # and bit for bit the kernel's chain a session at a time
                    chain = spikemm_sessions_chain_ref(*args)
                    if not torch.equal(g, chain):
                        raise AssertionError(
                            f"{name} [{label}]: differs from "
                            f"spikemm_sessions_chain_ref by "
                            f"{float((g - chain).abs().max()):.3e}")
                    extra = ", equal to spikemm_sessions_chain_ref bit for bit"
                elif name in ("spikemm_gather", "spikemm_gather_bwd"):
                    # the plain version's chain term for term (entries,
                    # then k): equal bit for bit, signs of zeros included
                    if not torch.equal(g.view(torch.int32),
                                       r.view(torch.int32)):
                        raise AssertionError(
                            f"{name} [{label}]: not bit-identical to "
                            f"spikemm_gather_ref (max abs err {err:.3e})")
                    extra = ", bit for bit"
                elif not same_bits(name, g, r):
                    raise AssertionError(
                        f"{name} [{label}]: not bit-identical to its plain "
                        f"version (max abs err {err:.3e})")
            if name == "spikemm_sparse":
                # it skips only silent work: equal to the dense kernel
                dense = spikemm_cuda(*args)
                if not torch.equal(got[0], dense):
                    raise AssertionError(
                        f"{name} [{label}]: differs from the dense kernel "
                        f"by {float((got[0] - dense).abs().max()):.3e}")
                occupied, blocks = check_occupancy(label, args[0])
                extra += ("; equal to the dense kernel bit for bit; "
                          f"occupancy kernel == block_occupancy ({occupied} "
                          f"of {blocks} blocks, total == flags.sum())")
            if name in ("spikemm_sessions", "stdp_seq_sessions"):
                extra += sessions_alone(name, args, kw, got[0])
            if name == "linrec_bwd" and args[1].shape[0] > 0:
                extra += linrec_bwd_flipped(
                    label, args, got[1 if kw.get("need_a", True) else 0])
            if case.rows_alone:
                # a row's result does not depend on the rows batched with it
                for i in range(args[0].shape[0]):
                    alone = cuda[name](args[0][i:i + 1].contiguous(), args[1])
                    if not torch.equal(alone[0], got[0][i]):
                        raise AssertionError(f"{name} [{label}]: row {i} alone "
                                             "differs from its row of the batch")
                extra += (f"; each of the {args[0].shape[0]} rows alone equal "
                          "to its row of the batch")
            if getattr(case, "dense_w", None) is not None:
                dense = spikemm_cuda(args[0], case.dense_w)
                torch.testing.assert_close(got[0], dense, rtol=0,
                                           atol=CHANNEL_TOL)
                extra += (f"; against the dense spikemm on dense_equivalent()"
                          f" {float((got[0] - dense).abs().max()):.3e}")
            shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
            if name in ("spikemm_gather", "spikemm_gather_bwd"):
                t = args[1]
                shapes.append(f"E={len(t.jj)} ({t.n_entries} active), "
                              f"bk={t.bk}, bn={t.bn}")
            if not case.timed:
                where = ""
                if route == "block":
                    n = args[0].shape[2]
                    bwd = name.endswith("_bwd")
                    smem = w_in_smem(n, backward=bwd)
                    most = BWD_SMEM_W_MAX_N if bwd else SMEM_W_MAX_N
                    if smem != (n <= most):
                        raise AssertionError(
                            f"{name} [{label}]: W_rec in shared memory is "
                            f"{smem}; this case is to run the "
                            f"{'shared' if n <= most else 'L2'} path")
                    where = (", W_rec in shared memory" if smem
                             else ", W_rec through L2")
                log(f"kernel {name} [{label}] {shapes}{where}: matches "
                    f"plain{extra} (max abs err so far {max_err:.3e})")
                continue
            heavy = name in ("lifrec", "alifrec", "alif", "spikemm_gather",
                             "stdp_seq", "spikemm_gather_bwd",
                             "stdp_seq_sessions") + BWD_SCANS
            ms = cuda_ms(lambda: cuda[name](*args, **kw), iters=200)
            # the recurrent backward's chain floor: T x N dependent adds at
            # the highest SM clock
            chain_ms = clock = None
            if name in ("lifrec_bwd", "alifrec_bwd"):
                clock = sm_max_clock_mhz()
                chain_ms = chain_floor_ms(*args[0].shape[::2])
            if name == "linrec_bwd":
                # B2's chain: a rounded product and a rounded add a step
                clock = sm_max_clock_mhz()
                chain_ms = chain_floor_ms(args[1].shape[0], 2)
            p_ms = cuda_ms(lambda: plain[name](*args, **kw),
                           iters=case.plain_iters or (5 if heavy else 20),
                           warmup=1 if case.plain_iters else 3)
            lib = (None if case.library is None
                   else cuda_ms(case.library, iters=200))
            # issue floors: of the operations the function needs, and of
            # those the kernel issues
            parent_ms = issue_ms = own_ms = None
            if name == "spikemm_gather_bwd":
                # the route B6 replaced: bit for bit its output, timed on
                # the same inputs
                run = parent_route(args)
                y = run()
                sync()
                if not torch.equal(y.view(torch.int32),
                                   got[0].view(torch.int32)):
                    raise AssertionError(f"{name} [{label}]: the parent "
                                         "route differs from the kernel")
                parent_ms = cuda_ms(run, iters=200)
                extra += "; the parent route bit for bit the same"
                issue_ms, own_ms = b6_floors(args)
            if name == "stdp_seq_sessions":
                issue_ms, own_ms = stdp_sessions_floors(args)
            # the sparse channel is its occupancy measure and its product:
            # time each alone, and the dense kernel on the same inputs
            kernel_ms = dense_ms = occ_ms = witness = None
            if name == "lif_bwd":
                kernel_ms = cuda_ms(lif_bwd_alone(args, kw), iters=200)
            if name in ("lif_bwd", "linrec_bwd"):
                # one launch a call: the kernel and nothing after it, on
                # the host (its counter, no PyTorch op that runs a kernel),
                # on the device (a CUDA graph of the call holds that one
                # kernel node and nothing else) and in the profiler's trace
                # where the tracer recorded one
                before = cuda[name].launches
                ops = host_ops(lambda: cuda[name](*args, **kw))
                if ops or cuda[name].launches != before + 1:
                    raise AssertionError(
                        f"{name} [{label}]: a call made "
                        f"{cuda[name].launches - before} launches and the "
                        f"PyTorch ops {ops}, not its one kernel alone")
                captured = graph_kernels(lambda: cuda[name](*args, **kw))
                ran = device_kernels(lambda: cuda[name](*args, **kw))
                for seen, how in ((captured, "captured"), (ran, "ran")):
                    if seen and (len(seen) != 1
                                 or f"{name}_kernel" not in seen[0]):
                        raise AssertionError(f"{name} [{label}]: a call "
                                             f"{how} {seen}, not its one "
                                             "kernel")
                if not captured:
                    raise AssertionError(f"{name} [{label}]: a CUDA graph "
                                         "of a call holds no node")
                if not ran:
                    log(f"{name} [{label}]: the profiler recorded no device "
                        "event; held by the CUDA graph's one node, the "
                        "launch counter and host ops")
                witness = {"graph": captured, "profiler": ran}
            if name == "alif_bwd":
                kernel_ms = cuda_ms(alif_bwd_alone(args, kw), iters=200)
            if name == "spikemm_sparse":
                occ, product = sparse_parts(*args)
                occ_ms = cuda_ms(occ, iters=200)
                kernel_ms = cuda_ms(product, iters=200)
                dense_ms = cuda_ms(lambda: spikemm_cuda(*args), iters=200)
            if name == "spikemm_wgrad":
                # the route it replaced: the dense kernel on the transposed
                # raster, the copy made before the timing
                raster_t = wgrad_raster(args, kw).t().contiguous()
                dense_ms = cuda_ms(lambda: spikemm_cuda(raster_t, args[1]),
                                   iters=200)
            # B6 is the gather's function on the transposed tables
            wname, wargs = (("spikemm_gather", (args[0], args[1].transpose()))
                            if name == "spikemm_gather_bwd" else (name, args))
            nbytes, flops, dense = work(wname, wargs, got, kw)
            b_ms, b_by = bound(nbytes, flops)
            d_ms, d_by = bound(nbytes, dense)
            # beside it, the gather's bound at the patch rows the kernel
            # reads, and if every active patch is read
            rows_ms, patches_ms = ((bound(gather_read_bytes(*wargs),
                                          flops)[0],
                                    bound(gather_patch_bytes(*wargs),
                                          flops)[0])
                                   if wname == "spikemm_gather"
                                   else (None, None))
            # the backward scans' u (and ALIF's a_{t-1}) scratch, written
            # in pass 1 and read in pass 2: not the function's bytes, this
            # design's, printed beside the bound
            planes = {"lifrec_bwd": 1, "alifrec_bwd": 2}.get(name)
            scratch_ms = (None if planes is None else bound(
                nbytes + 2 * 4 * planes * args[0].numel(), flops)[0])
            T = args[1].shape[0] if name in ("linrec", "linrec_bwd") else (
                args[0].shape[1] // kw["batch"] if name == "stdp_seq" else (
                    args[0].shape[1] // args[2].shape[0]
                    if name == "stdp_seq_sessions" else (
                        args[0].shape[0] if name not in (
                            "spikemm", "spikemm_sparse", "spikemm_gather",
                            "stdp", "spikemm_wgrad", "spikemm_gather_bwd",
                            "spikemm_sessions") else None)))
            calls.append({"call": label, "path": case.path, "shape": shapes,
                          "route": route, "ms": ms, "plain_ms": p_ms,
                          "library_ms": lib,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "bound_dense_ms": d_ms, "bound_dense_by": d_by,
                          "ms_per_step": None if T is None else ms / T,
                          "bytes": nbytes, "flops": flops,
                          "dense_flops": dense, "kernel_ms": kernel_ms,
                          "occupancy_ms": occ_ms,
                          "dense_kernel_ms": dense_ms,
                          "bound_rows_ms": rows_ms,
                          "bound_patches_ms": patches_ms,
                          "bound_scratch_ms": scratch_ms,
                          "chain_floor_ms": chain_ms, "sm_max_clock_mhz": clock,
                          "table_build_s": case.build_s,
                          "device_kernels": witness,
                          "parent_ms": parent_ms,
                          "issue_floor_ms": issue_ms,
                          "kernel_issue_floor_ms": own_ms})
            log(f"kernel {name} [{label}] {shapes}: {ms:.4f} ms on the card"
                f"{'' if T is None else f' ({ms / T * 1e3:.3f} us/step)'} "
                f"(plain {p_ms:.4f}, "
                f"library {lib if lib is None else round(lib, 4)}, bound "
                f"{b_ms:.5f} by {b_by}, dense bound {d_ms:.5f} by {d_by}, "
                f"{ms / max(b_ms, floor):.2f}x max(bound, floor)"
                f"{'' if occ_ms is None else f', occupancy alone {occ_ms:.4f}, product alone {kernel_ms:.4f}, dense kernel {dense_ms:.4f}'}"
                f"{'' if name != 'spikemm_wgrad' else f', the dense kernel on the transposed raster {dense_ms:.4f}'}"
                f"{'' if patches_ms is None else f', read-rows bound {rows_ms:.5f}, every-patch bound {patches_ms:.5f}'}"
                f"{'' if scratch_ms is None else f', bound with the scratch {scratch_ms:.5f}'}"
                f"{'' if chain_ms is None else f', chain floor {chain_ms:.5f} at the highest SM clock {clock} MHz ({ms / chain_ms:.2f}x)'}"
                f"{'' if kernel_ms is None or occ_ms is not None else f', kernel alone {kernel_ms:.4f}'}"
                f"{'' if case.build_s is None else f', tables built in {case.build_s:.1f} s'}"
                f"{'' if parent_ms is None else f', parent route {parent_ms:.4f} ({parent_ms / ms:.2f}x)'}"
                f"{'' if issue_ms is None else f', issue floor {issue_ms:.5f} ({FLOORS[name][0]}), {own_ms:.5f} ({FLOORS[name][1]})'})"
                f"{extra}; max abs err so far {max_err:.3e}")
        src, rep = SOURCES[name]
        home = [c for c in calls if c["path"] == HOME[name]]
        top = max(home, key=lambda c: c["bound_ms"])
        per_step = [c["ms_per_step"] for c in home
                    if c["ms_per_step"] is not None]
        results[name] = {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": None, "max_abs_err": max_err,
            "path": HOME[name],
            "ms": sum(c["ms"] for c in home),
            "ms_per_step": sum(per_step) if per_step else None,
            "plain_ms": sum(c["plain_ms"] for c in home),
            "bound_ms": sum(c["bound_ms"] for c in home),
            "bound_by": top["bound_by"],
            "bound_dense_ms": sum(c["bound_dense_ms"] for c in home),
            "floor_ms": floor,
            "library_ms": (None if any(c["library_ms"] is None for c in home)
                           else sum(c["library_ms"] for c in home)),
            "kernel_ms": (None if any(c["kernel_ms"] is None for c in home)
                          else sum(c["kernel_ms"] for c in home)),
            "chain_floor_ms": (None if any(c["chain_floor_ms"] is None
                                           for c in home)
                               else sum(c["chain_floor_ms"] for c in home)),
            "occupancy_ms": (None if any(c["occupancy_ms"] is None
                                         for c in home)
                             else sum(c["occupancy_ms"] for c in home)),
            "parent_ms": (None if any(c["parent_ms"] is None for c in home)
                          else sum(c["parent_ms"] for c in home)),
            "issue_floor_ms": (None if any(c["issue_floor_ms"] is None
                                           for c in home)
                               else sum(c["issue_floor_ms"] for c in home)),
            "calls": calls}
    return results


def sessions_alone(name, args, kw, got):
    """Each session of a session-axis call (`spikemm_sessions`,
    `stdp_seq_sessions`) equals, bit for bit, the unbatched kernel on that
    session's rows alone (`spikemm` on its (T, K) rows against its weight;
    `stdp_seq` at batch 1 on rows t * S + s): the isolation invariant of
    learning serve windows. Raises, or returns what it checked."""
    from repro_torch.kernels.spikemm.ops import spikemm_cuda
    from repro_torch.kernels.stdp.ops import stdp_seq_cuda
    S = (args[2] if name == "stdp_seq_sessions" else args[1]).shape[0]
    for i in range(S):
        if name == "spikemm_sessions":
            alone = spikemm_cuda(args[0][:, i].contiguous(), args[1][i])
            mine = got[:, i].contiguous()
        else:
            P, Q, w = args
            alone = stdp_seq_cuda(P[:, i::S].contiguous(),
                                  Q[:, i::S].contiguous(), w[i], batch=1,
                                  **kw)
            mine = got[i]
        if not torch.equal(alone.view(torch.int32), mine.view(torch.int32)):
            raise AssertionError(f"{name}: session {i} differs from the "
                                 "unbatched kernel on its rows alone")
    return (f"; each of the {S} sessions equal to the unbatched kernel on "
            "its rows alone, bit for bit")


def parent_route(args):
    """A function of no argument that launches, uncounted, the route B6
    replaced on the same inputs and returns its output: the forward
    gather's event walk (`csrc/spikemm_gather.cu`, still the forward's
    kernel) on the transposed tables under `gather_plan`."""
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.spikemm import gather
    g, tables = args
    t = tables.transpose()
    out = torch.empty((g.shape[0], t.n_post), device=DEV)
    plan = gather.gather_plan(g.shape[0], t.bn, t.n_post_blocks,
                              sm_count(g.device))

    def run():
        gather.launch_plan(g, t, out, plan)
        return out
    return run


def b6_floors(args):
    """B6's issue floors in ms at the highest SM clock, two fp32 issues (a
    multiply, an add) a term on 128 lanes an SM: the terms the function
    needs (M x the nonzero weights) and the terms its walk adds (M x the
    listed (32 x 32) sub-tiles x 1024)."""
    from repro_torch.kernels.common import sm_count
    g, tables = args
    rate = sm_count(g.device) * 128 * sm_max_clock_mhz() * 1e3   # per ms
    need = g.shape[0] * int(np.count_nonzero(tables.wblk))
    walked = g.shape[0] * len(tables.transpose().bwd_steps()[1]) * 1024
    return 2 * need / rate, 2 * walked / rate


def stdp_sessions_floors(args):
    """`stdp_seq_sessions`' issue floors in ms at the highest SM clock, one
    fp32 operation a lane a cycle on 128 lanes an SM: the plain order's
    (4K + 3) a weight a step (a product p q, the sum 0 + p q, its product
    by amp_k and the sum into dw for each of K terms, then w + dw and the
    clip's max and min) and the kernel's 3K + 3 (`csrc/stdp_sessions.cu`
    drops each 0 + p q, leaving every bit as it was)."""
    from repro_torch.kernels.common import sm_count
    P, _, w = args
    K, rows = P.shape[:2]
    S, M, N = w.shape
    rate = sm_count(w.device) * 128 * sm_max_clock_mhz() * 1e3   # per ms
    steps = S * M * N * (rows // S)
    return (4 * K + 3) * steps / rate, (3 * K + 3) * steps / rate


def phase_rec_bwd_passes(cases):
    """Where the recurrent backward's warp route spends its time, by pass:
    `lifrec_bwd` and `alifrec_bwd` at train_ecg's captured step call,
    through their wrappers on the clock-stamped build (`phase_build`),
    whose outputs must equal the library's bit for bit. Mean cycles of the
    prologue, pass 1 and pass 2 over the blocks (a stamped call after the
    timing), and the stamped build's own ms. Launches here are not the
    main path's: its counts are set to 0 before each path."""
    from repro_torch.kernels import _build
    cuda = kernel_impls()[0]
    out = {}
    for name in ("lifrec_bwd", "alifrec_bwd"):
        case = next(c for c in cases[name] if c.path == "train_ecg")
        T, B = case.args[0].shape[:2]
        ref = cuda[name](*case.args, **case.kw)
        package = _build.library
        _build.library = lambda: _PASS_LIB
        try:
            ms = cuda_ms(lambda: cuda[name](*case.args, **case.kw),
                         iters=200)
            got = cuda[name](*case.args, **case.kw)
            sync()
        finally:
            _build.library = package
        if not all(torch.equal(g, r) for g, r in zip(got, ref)
                   if g is not None):
            raise AssertionError(f"{name}: the clock-stamped build's "
                                 "outputs differ from the library's")
        clk = torch.zeros(4 * B, dtype=torch.int64)
        _build.check(name, _PASS_LIB.rec_bwd_pass_clocks(clk.data_ptr(),
                                                         4 * B))
        d = clk.view(B, 4).double().diff(dim=1).mean(0).tolist()
        steps2 = max(T - 1, 1)
        out[name] = {"call": case.label, "stamped_ms": ms,
                     "prologue_cycles": d[0], "pass1_cycles": d[1],
                     "pass2_cycles": d[2], "pass1_cycles_a_step": d[1] / T,
                     "pass2_cycles_a_step": d[2] / steps2}
        log(f"passes {name} [{case.label}]: stamped build {ms:.4f} ms; "
            f"prologue {d[0]:.0f}, pass 1 {d[1]:.0f} ({d[1] / T:.1f} a "
            f"step), pass 2 {d[2]:.0f} ({d[2] / steps2:.1f} a step) cycles, "
            f"mean of {B} blocks; bit for bit the library's")
    return out


# the lane backward kernels' phases (`lif_bwd`, `alif_bwd`, `linrec_bwd`),
# in the order of their -D..._PASS_CLOCKS slots (`csrc/lane_bwd.cuh`:
# summed over their segments), the phases each kernel has, and each
# kernel's home calls: its training paths' steps
LANE_BWD_PHASES = ("load", "forward", "surrogate", "reverse", "store",
                   "sums", "cotangent wait")
LANE_BWD_SLOTS = 8
LANE_BWD_HOME = {"lif_bwd": ("train_shd",), "alif_bwd": ("train_alif_ff",),
                 "linrec_bwd": ("train_shd", "train_ecg")}
LANE_BWD_OWN_PHASES = {"linrec_bwd": ("load", "reverse", "store", "sums")}


def phase_lane_bwd_passes(cases, name):
    """Where a lane backward kernel (`lif_bwd`, `alif_bwd`, `linrec_bwd`)
    spends its time, by phase: each of its training paths' captured step
    calls through the wrapper on the clock-stamped build (`phase_build`),
    its outputs equal to the library's bit for bit. Mean cycles of each
    phase over the blocks (a stamped call after the timing), the whole
    kernel's, and the stamped build's own ms."""
    from repro_torch.kernels import _build
    cuda = kernel_impls()[0]
    outs = []
    for case in (c for c in cases[name] if c.path in LANE_BWD_HOME[name]):
        T, B, N = case.args[1 if name == "linrec_bwd" else 0].shape
        blocks = -(-B * N // 32)
        ref = cuda[name](*case.args, **case.kw)
        package = _build.library
        _build.library = lambda: _PASS_LIB
        try:
            ms = cuda_ms(lambda: cuda[name](*case.args, **case.kw),
                         iters=200)
            got = cuda[name](*case.args, **case.kw)
            sync()
        finally:
            _build.library = package
        if not all(torch.equal(g, r) for g, r in zip(got, ref)
                   if g is not None):
            raise AssertionError(f"{name}: the clock-stamped build's "
                                 "outputs differ from the library's")
        clk = torch.zeros(LANE_BWD_SLOTS * blocks, dtype=torch.int64)
        _build.check(name, getattr(_PASS_LIB, f"{name}_pass_clocks")(
            clk.data_ptr(), LANE_BWD_SLOTS * blocks))
        per_block = clk.view(blocks, LANE_BWD_SLOTS).double()
        mean = per_block.mean(0).tolist()
        most = per_block.max(0).values.tolist()
        own = LANE_BWD_OWN_PHASES.get(name, LANE_BWD_PHASES)
        phases = {k: v for k, v in zip(LANE_BWD_PHASES, mean) if k in own}
        outs.append({"call": case.label, "stamped_ms": ms, "blocks": blocks,
                     "cycles": phases,
                     "cycles_a_step": {k: v / T for k, v in phases.items()},
                     "most_cycles": {k: v for k, v in zip(LANE_BWD_PHASES,
                                                         most) if k in own},
                     "total_cycles": mean[-1], "most_total_cycles": most[-1]})
        log(f"passes {name} [{case.label}]: stamped build {ms:.4f} ms; "
            + ", ".join(f"{k} {v:.0f} ({v / T:.1f} a step)"
                        for k, v in phases.items())
            + f", whole kernel {mean[-1]:.0f} cycles, mean of {blocks} "
            f"blocks (the slowest block's: {most[-1]:.0f} in all, sums "
            f"{most[5]:.0f}); bit for bit the library's")
    return {name: outs}


# spikemm_wgrad's phases, in the order of its -DWGRAD_PASS_CLOCKS slots
# (slot 4 counts the steps computed)
WGRAD_PHASES = ("wait", "issue", "products", "barrier", "live steps",
                "combine")


def phase_wgrad_passes(cases):
    """Where `spikemm_wgrad` spends its time, by phase: each training g_w
    call through the wrapper on the clock-stamped build (`phase_build`),
    its output equal to the library's bit for bit. Mean cycles of each
    phase over the CTAs, the steps computed, the whole kernel's (mean and
    most), and the stamped build's own ms."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.spikemm.wgrad import (spikemm_wgrad_cuda,
                                                   wgrad_tile, wgrad_tiles)
    out = {}
    for case in (c for c in cases["spikemm_wgrad"] if c.path):
        R, K, N = wgrad_shape(case.args)
        kt, nt = wgrad_tiles(K, N)
        blocks = kt * nt * wgrad_tile(K, N)[2]
        ref = spikemm_wgrad_cuda(*case.args, **case.kw)
        package = _build.library
        _build.library = lambda: _PASS_LIB
        try:
            ms = cuda_ms(lambda: spikemm_wgrad_cuda(*case.args, **case.kw),
                         iters=100)
            got = spikemm_wgrad_cuda(*case.args, **case.kw)
            sync()
        finally:
            _build.library = package
        if not torch.equal(got, ref):
            raise AssertionError(f"spikemm_wgrad [{case.label}]: the "
                                 "clock-stamped build differs from the "
                                 "library")
        clk = torch.zeros(8 * blocks, dtype=torch.int64)
        _build.check("spikemm_wgrad",
                     _PASS_LIB.wgrad_pass_clocks(clk.data_ptr(), 8 * blocks))
        v = clk.view(blocks, 8).double()
        mean = v.mean(0).tolist()
        phases = dict(zip(WGRAD_PHASES, mean))
        out[case.label] = {"stamped_ms": ms, "ctas": blocks,
                           "tile": list(wgrad_tile(K, N)),
                           "cycles": phases, "total_cycles": mean[7],
                           "most_cycles": float(v[:, 7].max())}
        log(f"passes spikemm_wgrad [{case.label}]: stamped build {ms:.4f} "
            f"ms, tile {wgrad_tile(K, N)}, {blocks} CTAs; "
            + ", ".join(f"{k} {x:.1f}" if k == "live steps"
                        else f"{k} {x:.0f}" for k, x in phases.items())
            + f", whole kernel {mean[7]:.0f} (most {v[:, 7].max():.0f}) "
            "cycles, mean over the CTAs; bit for bit the library's")
    return {"spikemm_wgrad": out}


def phase_gather_rows(cases):
    """The gather's rows a warp and columns a lane, measured: each timed
    gather case with 8 rows or more launched under `gather_plan` at every
    instantiation (R of GATHER_ROWS x C of GATHER_COLS, C dividing bn and
    a warp no wider than bn, R x C <= GATHER_MAX_ACC; `launch_plan`,
    uncounted), each
    output equal to the wrapper's bit for bit, timed with `cuda_ms`.
    {case: {"R x C": ms, "plan": the wrapper's}}."""
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.spikemm.gather import (GATHER_COLS,
                                                    GATHER_MAX_ACC,
                                                    GATHER_ROWS, gather_plan,
                                                    launch_plan,
                                                    spikemm_gather_cuda)
    res = {}
    for case in cases:
        s, t = case.args
        M = s.shape[0]
        if not case.timed or M < 8:
            continue
        want = spikemm_gather_cuda(s, t)
        n_sm = sm_count(s.device)
        pick = gather_plan(M, t.bn, t.n_post_blocks, n_sm)
        row = {"plan": f"{pick.rows} x {pick.cols}"}
        for C in GATHER_COLS:
            if t.bn % C or 32 * C > max(t.bn, 32):
                continue
            for R in GATHER_ROWS:
                if R * C > GATHER_MAX_ACC:
                    continue
                plan = gather_plan(M, t.bn, t.n_post_blocks, n_sm, rows=R,
                                   cols=C)
                out = torch.empty_like(want)
                launch_plan(s, t, out, plan)
                sync()
                if not torch.equal(out.view(torch.int32),
                                   want.view(torch.int32)):
                    raise AssertionError(
                        f"spikemm_gather [{case.label}]: {R} rows a warp x "
                        f"{C} columns a lane differs from the plan's")
                row[f"{R} x {C}"] = cuda_ms(
                    lambda: launch_plan(s, t, out, plan), iters=50)
        log(f"gather rows a warp x columns a lane [{case.label}]: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()
                        if k != "plan")
            + f"; the plan takes {row['plan']}; all bit for bit")
        res[case.label] = row
    return res


def same_bits(name, got, ref):
    """Whether a kernel's output equals its plain version's: as values
    (`torch.equal`), and for the lane scans (`linrec`, `lif`, `alif`) as
    fp32 bit patterns too, so that -0.0 and +0.0 differ."""
    if not torch.equal(got, ref):
        return False
    return (name not in LANE_SCANS + BWD_SCANS
            or torch.equal(got.view(torch.int32), ref.view(torch.int32)))


def cut_steps(name, args, kw, T):
    """The call `args` of a serial-chain kernel cut to its first T steps."""
    if name == "stdp_seq":
        P, Q, w = args
        rows = T * kw["batch"]
        return (P[:, :rows].contiguous(), Q[:, :rows].contiguous(), w)
    if name == "linrec":
        a, x, h0 = args                # a stays a view: stride 0 stays 0
        return (a[:T] if a.dim() == x.dim() else a, x[:T].contiguous(), h0)
    if name in BWD_SCANS:              # the current, spikes and cotangent
        return tuple(a[:T].contiguous() if torch.is_tensor(a)
                     and a.shape == args[0].shape else a for a in args)
    return (args[0][:T].contiguous(),) + tuple(args[1:])


def fit_line(xs, ys):
    """(a, b) of the least-squares line y = a + b x."""
    b, a = np.polyfit(np.asarray(xs, float), np.asarray(ys, float), 1)
    return float(a), float(b)


def sweep_cases():
    """The home-path calls of the serial-chain kernels alone: the
    plastic_ff pair rule's `stdp_seq` planes and the ECG window's hidden
    layer, heterogeneous (`alifrec`) and homogeneous (`lifrec`); and the
    lane scans' calls: the plastic_ff pair rule's `linrec` calls, the four
    paths' `lif` calls and alif_ff's `alif` call; and the recurrent
    backward's calls of a train_ecg step (`train_cases`)."""
    return {"stdp_seq": plastic_seq_cases(("pair_stdp",)),
            "alifrec": [Case("ECG hidden", ecg_window(True)["alifrec"][0][1],
                             path="ecg", timed=True)],
            "lifrec": [Case("ECG hidden", ecg_window(False)["lifrec"][0][1],
                            path="ecg_homogeneous", timed=True)],
            "linrec": plastic_linrec_cases(),
            "lif": path_lif_cases(),
            "alif": [Case("ALIF-ff hidden", alif_ff_run_inputs(),
                          path="alif_ff", timed=True)],
            **{name: calls for name, calls in train_cases().items()
               if name in ("lifrec_bwd", "alifrec_bwd")}}


def phase_sweep(cases):
    """Where a serial-chain kernel's time goes: its home-path call cut to
    each of SWEEP_T's step counts, checked bit for bit against the plain
    version and timed with CUDA events; the fit ms = a + b * T splits the
    time into launch and prologue (a) and the cost of a step (b)."""
    cuda, plain = kernel_impls()
    out = {"floor_ms": launch_floor_ms()}
    for name, steps in SWEEP_T.items():
        if name in SWEEP_CALL:
            case = next(c for c in cases[name] if c.label == SWEEP_CALL[name])
        else:
            case = next(c for c in cases[name] if c.path == HOME[name])
        ms = []
        for T in steps:
            args = cut_steps(name, case.args, case.kw, T)
            got = cuda[name](*args, **case.kw)
            ref = plain[name](*args, **case.kw)
            sync()
            for g, r in zip(got if isinstance(got, tuple) else (got,),
                            ref if isinstance(ref, tuple) else (ref,)):
                if g is None and r is None:
                    continue
                if case.rtol is not None:   # sigmoid: the kernel's expf
                    torch.testing.assert_close(g, r, rtol=case.rtol,
                                               atol=case.atol)
                elif not same_bits(name, g, r):
                    raise AssertionError(
                        f"sweep {name} [{case.label}] T={T}: not bit-identical"
                        f" to its plain version "
                        f"({float((g - r).abs().max()):.3e})")
            ms.append(cuda_ms(lambda: cuda[name](*args, **case.kw),
                              iters=200))
        a, b = fit_line(steps, ms)
        out[name] = {"call": case.label, "path": case.path, "T": list(steps),
                     "ms": ms, "a_ms": a, "b_ms_per_step": b}
        log(f"sweep {name} [{case.label}]: " + ", ".join(
            f"T={T} {t:.5f} ms" for T, t in zip(steps, ms))
            + f"; fit a = {a:.5f} ms, b = {b * 1e3:.4f} us a step "
            + ("(within the sigmoid tolerance at every T)"
               if case.rtol is not None else "(bit for bit at every T)"))
    return out


# ---------------------------------------------------------------------------
# 4. paths through the engine
# ---------------------------------------------------------------------------


def replay(eng, trace, latencies=None):
    """Drive the trace through an engine (a window per round boundary,
    then drain); per-window host latency of each step() that served a
    cohort, synchronized with the card, goes into `latencies`."""
    last = {}
    for r, sid, _ in trace:
        last[sid] = max(last.get(sid, -1), r)

    def step():
        t0 = time.perf_counter()
        n = eng.step()
        if eng.device.type == "cuda":
            sync()
        if n and latencies is not None:
            latencies.append(time.perf_counter() - t0)
        return n

    cur = 0
    for r, sid, chunk in trace:
        while r > cur:
            step()
            cur += 1
        if sid not in eng.scheduler.sessions:
            eng.open(sid)
        if not eng.submit(sid, chunk):
            raise AssertionError(f"submit rejected for {sid}")
        if last[sid] == r:
            eng.close(sid)
    while step():
        pass
    return eng


def profile_ms(fn):
    """Card time of everything `fn` runs, traced with torch.profiler: (ms
    in all, {kernel: ms}), or (None, {}) when the trace holds no device
    events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + \
                ev.device_time_total / 1e3
    if not by_name:
        return None, {}
    return sum(by_name.values()), by_name


def top_per(by_name, units, n=10):
    """The `n` largest entries of {kernel: ms}, each divided by `units`."""
    return {k: v / units for k, v in
            sorted(by_name.items(), key=lambda kv: -kv[1])[:n]}


def kernel_share(by_name, total, needle):
    """(ms, share of `total`) of the kernels of {kernel: ms} whose name
    holds `needle`, or (None, None) where the trace holds none of them."""
    ms = sum(v for k, v in by_name.items() if needle in k)
    if not ms or not total:
        return None, None
    return ms, ms / total


def device_profile(eng_factory, trace):
    """Card time per window, by kernel, over one replay traced with
    torch.profiler: (total ms per window, {kernel: ms per window}), or
    (None, {}) when the trace holds no device events."""
    eng = eng_factory()
    total, by_name = profile_ms(lambda: replay(eng, trace))
    wins = eng.metrics.windows_run
    if total is None:
        return None, {}
    return total / wins, top_per(by_name, wins)


def host_breakdown(eng, trace):
    """Mean ms per served window in each host-side stage of
    `engine.step()`, from spans recorded around the calls into each layer
    (each span synchronizes the card, so stages do not overlap here as
    they may in the untraced run). "other" is the rest of step()."""
    from repro_torch.core import plan as plan_mod
    spans, total = {}, []

    def span(name, fn):
        def timed(*a, **k):
            sync()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            sync()
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0
            return r
        return timed

    saved = {n: getattr(plan_mod, n) for n in ("pack_states", "run",
                                               "unpack_state")}
    try:
        for n, fn in saved.items():
            setattr(plan_mod, n, span(f"plan.{n}", fn))
        eng._window = span("input window to card", eng._window)
        eng.cache.get = span("cache.get", eng.cache.get)
        eng.cache.put = span("cache.put", eng.cache.put)
        eng.scheduler.next_cohort = span("scheduler.next_cohort",
                                         eng.scheduler.next_cohort)
        replay(eng, trace, total)
    finally:
        for n, fn in saved.items():
            setattr(plan_mod, n, fn)
    wins = eng.metrics.windows_run
    out = {k: v * 1e3 / wins for k, v in spans.items()}
    out["step total"] = sum(total) * 1e3 / wins
    out["other"] = out["step total"] - sum(v for k, v in out.items()
                                           if k != "step total")
    return out


def load_tie_rule():
    """The threshold-tie helper the tests use, `tests/_torch_parity.py`,
    loaded from the checkout by path (a top-level `tests` package installed
    elsewhere would shadow the repo's `tests` directory)."""
    path = ROOT / "tests" / "_torch_parity.py"
    spec = importlib.util.spec_from_file_location("_torch_parity", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def counted(tag, per_run, runs, counts):
    """Raise unless `counts` holds exactly `per_run` x `runs` launches of
    each kernel (0 for the kernels not named)."""
    want = {n: per_run.get(n, 0) * runs for n in counts}
    if counts != want or not set(per_run) <= set(counts):
        raise AssertionError(f"[{tag}] launch counts {counts} != {want} "
                             f"({per_run} per run x {runs})")


def card_vs_cpu(tag, nodes_c, params_c, x, st_gpu, o_gpu, r_gpu,
                tie_params=None, floor=True, readout_rtol=0.0):
    """Hold a card run of `plan.run` against the CPU's on the same input
    (T, B, n_in): hidden spikes under the tie rule (row-wise for a
    self-recurrent layer), the 1 % floor, readouts before each row's first
    divergence and the final states of the rows that never diverged.

    `tie_params` replaces the hidden node's numpy parameters for the tie
    rule's membrane (a topology-backed input edge passes its topology as
    "w_input"); with `floor=False` a layer under the floor is compared all
    the same and the caller reports that the comparison does not count;
    readouts are held to READOUT_TOL + readout_rtol * |CPU readout|.
    Returns (CPU hidden spikes, first divergence per row, tie flips,
    readout error, state error, undiverged rows, readout error relative
    to max(1, |CPU readout|))."""
    from repro_torch.core import plan
    from repro_torch.weights import params_to_numpy
    tie = load_tie_rule()
    T = x.shape[0]
    st_cpu, o_cpu, r_cpu = plan.run(nodes_c, params_c, torch.from_numpy(x),
                                    record=("hidden",), device="cpu")
    o_cpu = o_cpu.numpy()
    s_cpu = r_cpu["hidden"].numpy()
    if floor and not s_cpu.mean() >= MIN_HIDDEN_RATE:
        raise AssertionError(
            f"[{tag}] hidden layer fires in {s_cpu.mean():.4%} of its "
            f"lane-steps, under {MIN_HIDDEN_RATE:.0%}: the comparison "
            "would be vacuous")
    if tie_params is None:
        tie_params = params_to_numpy(params_c)["hidden"]
    u, th = tie.hidden_membrane(nodes_c[0], tie_params, x, s_cpu)
    first_div, n_ties = tie.tie_rule(s_cpu, r_gpu["hidden"].cpu().numpy(),
                                     u, th,
                                     rowwise=tie.is_recurrent(nodes_c[0]))
    err_plan = tie.max_err_before(o_cpu, o_gpu, first_div)
    scale = np.maximum(1.0, np.abs(o_cpu))
    err_rel = tie.max_err_before(o_cpu / scale, o_gpu / scale, first_div)
    over = tie.max_err_before(
        np.zeros_like(o_cpu), np.maximum(
            0.0, np.abs(o_gpu - o_cpu) - READOUT_TOL
            - readout_rtol * np.abs(o_cpu)), first_div)
    if over > 0:
        raise AssertionError(f"[{tag}] plan.run readout card vs CPU "
                             f"{err_plan:.3e} (relative {err_rel:.3e}) > "
                             f"{READOUT_TOL} + {readout_rtol} * |readout|")
    # final states (membranes, adaptation, branch currents, the recurrent
    # `out`, readout) of the rows whose hidden spikes never diverged: these
    # carry every input of the run, also where the hidden layer barely fires
    rows = torch.from_numpy(first_div >= T)
    err_state = 0.0
    for node in st_cpu:
        for k, ref in st_cpu[node].items():
            if k.startswith("syn:"):         # learning is checked apart
                continue
            got = st_gpu[node][k].cpu()
            got, ref = (got[:, rows], ref[:, rows]) if k == "ring" else \
                (got[rows], ref[rows])
            torch.testing.assert_close(got, ref, rtol=READOUT_TOL,
                                       atol=READOUT_TOL,
                                       msg=lambda m: f"[{tag}] state "
                                       f"{node}.{k} card vs CPU: {m}")
            if got.numel():
                err_state = max(err_state, float((got - ref).abs().max()))
    return s_cpu, first_div, n_ties, err_plan, err_state, rows, err_rel


def rec_routes_taken(tag, before, counts, width):
    """{kernel: {route: launches}} of the recurrent scans since `before`
    (`rec_route_launch_counts()`): every launch of the main path on the
    route its hidden width plans, `rec_route(width)`, and none on the
    other."""
    from repro_torch.kernels.common import rec_route, rec_route_launch_counts
    after = rec_route_launch_counts()
    taken = {k: {r: n - before[k][r] for r, n in v.items()}
             for k, v in after.items()}
    for k, by_route in taken.items():
        want = {r: counts[k] * (r == rec_route(width)) for r in by_route}
        if by_route != want:
            raise AssertionError(f"[{tag}] {k} route launches {by_route}, "
                                 f"planned {want}")
    return taken


def phase_path(path: ServePath, smi):
    from repro_torch.core import plan
    from repro_torch.kernels import registry
    from repro_torch.kernels.common import rec_route_launch_counts
    from repro_torch.serve import EngineConfig, make_engine

    tag = path.name
    nodes, params = path.make_model(DEV)
    nodes_c, params_c = path.make_model("cpu")
    cfg = EngineConfig(window=WINDOW, capacity=CAPACITY, queue_limit=None)
    streams = path.streams()
    trace = make_trace(streams)
    n_in = next(iter(streams.values())).shape[1]

    # warm-up outside the measured run: CUDA context, allocator, kernels
    replay(make_engine(nodes, params, cfg, device=DEV),
           make_trace({k: v[:96] for k, v in list(streams.items())[:4]}))
    sync()

    # -- the main path: launch counters from 0 --------------------------------
    registry.reset_launches()
    routes0 = rec_route_launch_counts()
    lat, walls = [], []

    def timed_replay():
        t0 = time.perf_counter()
        e = replay(make_engine(nodes, params, cfg, device=DEV), trace, lat)
        sync()
        walls.append(time.perf_counter() - t0)
        return e

    eng = timed_replay()
    counts = registry.launch_counts()
    wins = eng.metrics.windows_run
    counted(tag, path.per_window, wins, counts)
    routes = rec_routes_taken(tag, routes0, counts, next(
        n.out_dim for n in nodes if n.name == "hidden"))
    log(f"path [{tag}]: {len(streams)} sessions, {wins} windows, launches "
        f"{counts} ({path.per_window} per window); recurrent scan routes "
        f"{routes}")

    # -- the engine equals a one-shot plan.run of every session ---------------
    x = side_by_side(streams, n_in)
    T = x.shape[0]
    st_gpu, o_gpu, r_gpu = plan.run(nodes, params, torch.from_numpy(x).to(DEV),
                                    record=("hidden",), device=DEV)
    o_gpu = o_gpu.cpu().numpy()
    n_out = nodes[-1].out_dim
    for b, (sid, v) in enumerate(streams.items()):
        got = eng.outputs(sid)
        if got.shape != (len(v), n_out) or not np.all(np.isfinite(got)):
            raise AssertionError(f"[{tag}] {sid}: outputs {got.shape}, "
                                 f"expected finite ({len(v)}, {n_out})")
        if not np.array_equal(got, o_gpu[:len(v), b]):
            raise AssertionError(f"[{tag}] {sid}: engine outputs differ from "
                                 "the one-shot plan.run on the card")

    # -- the card against the CPU, under the tie rule -------------------------
    s_cpu, first_div, n_ties, err_plan, err_state, rows, _ = card_vs_cpu(
        tag, nodes_c, params_c, x, st_gpu, o_gpu, r_gpu)
    eng_c = replay(make_engine(nodes_c, params_c, cfg, device="cpu"), trace)
    err_eng = 0.0
    for b, (sid, v) in enumerate(streams.items()):
        t0_ = min(int(first_div[b]), len(v))
        if t0_:
            err_eng = max(err_eng, float(np.max(np.abs(
                eng.outputs(sid)[:t0_] - eng_c.outputs(sid)[:t0_]))))
    if err_eng > READOUT_TOL:
        raise AssertionError(f"[{tag}] engine readout card vs CPU "
                             f"{err_eng:.3e} > {READOUT_TOL}")
    log(f"path [{tag}]: card vs CPU: hidden spikes {int(s_cpu.sum())} "
        f"(rate {s_cpu.mean():.4f}), {n_ties} lanes flipped at threshold "
        f"ties, {int((first_div < T).sum())} rows diverged, readout max abs "
        f"err {err_plan:.3e} (plan.run), {err_eng:.3e} (engine); final "
        f"states of {int(rows.sum())} undiverged rows max abs err "
        f"{err_state:.3e}")

    # -- one session solo against packed --------------------------------------
    solo_sid = next(iter(streams))
    solo = replay(make_engine(nodes, params, cfg, device=DEV),
                  [e for e in trace if e[1] == solo_sid])
    if not np.array_equal(solo.outputs(solo_sid), eng.outputs(solo_sid)):
        raise AssertionError(f"[{tag}] {solo_sid}: solo != packed outputs")
    st_solo, st_packed = solo.state_of(solo_sid), eng.state_of(solo_sid)
    for node in st_solo:
        for k in st_solo[node]:
            if not torch.equal(st_solo[node][k], st_packed[node][k]):
                raise AssertionError(f"[{tag}] {solo_sid}: solo != packed "
                                     f"state {node}.{k}")
    log(f"path [{tag}]: {solo_sid} solo == packed, bit for bit")

    out = {"path": tag, "model": path.model, "window": WINDOW,
           "capacity": CAPACITY, "sessions": len(streams), "windows": wins,
           "launches": counts, "launches_per_window": path.per_window,
           "rec_route_launches": routes, "input": path.input,
           "hidden_spikes": int(s_cpu.sum()),
           "hidden_rate": float(s_cpu.mean()), "tie_flips": n_ties,
           "rows_diverged": int((first_div < T).sum()),
           "readout_max_abs_err": max(err_plan, err_eng),
           "state_max_abs_err": err_state}
    if path.timed:
        for _ in range(REPLAYS - 1):
            timed_replay()
        wall = float(np.median(walls))
        dev_ms, top = device_profile(
            lambda: make_engine(nodes, params, cfg, device=DEV), trace)
        host = host_breakdown(make_engine(nodes, params, cfg, device=DEV),
                              trace)
        steps = sum(len(s) for s in streams.values())
        mean_ms = float(np.mean(lat)) * 1e3
        out.update({
            "replays": len(walls), "window_samples": len(lat),
            "p50_window_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_window_ms": float(np.percentile(lat, 99)) * 1e3,
            "mean_window_ms": mean_ms,
            "sessions_per_s": len(streams) / wall,
            "steps_per_s": steps / wall,
            "median_replay_wall_s": wall,
            "device_ms_per_window": dev_ms,
            "device_busy_share": (None if dev_ms is None
                                  else dev_ms / mean_ms),
            "device_ms_per_window_by_kernel": top,
            "host_ms_per_window_by_stage": host,
            "card": smi})
    return out


# ---------------------------------------------------------------------------
# 5. the ALIF feed-forward path
# ---------------------------------------------------------------------------


def phase_alif_ff(smi):
    """One `plan.run` of the bench's `shd_alif_ff` program on the card."""
    from repro_torch.core import plan
    from repro_torch.kernels import registry
    tag = "alif_ff"
    nodes, params = make_alif_ff(DEV)
    nodes_c, params_c = make_alif_ff("cpu")
    x = alif_ff_input()
    xg = torch.from_numpy(x).to(DEV)
    plan.run(nodes, params, xg[:8], device=DEV)          # warm-up
    sync()
    registry.reset_launches()
    st_gpu, o_gpu, r_gpu = plan.run(nodes, params, xg, record=("hidden",),
                                    device=DEV)
    sync()
    counts = registry.launch_counts()
    per_run = {"spikemm": 2, "alif": 1, "linrec": 1}
    counted(tag, per_run, 1, counts)
    o_gpu = o_gpu.cpu().numpy()
    if o_gpu.shape != (ALIF_T, ALIF_B, N_OUT) or \
            not np.all(np.isfinite(o_gpu)):
        raise AssertionError(f"[{tag}] outputs {o_gpu.shape}, expected "
                             f"finite {(ALIF_T, ALIF_B, N_OUT)}")
    s_cpu, first_div, n_ties, err_plan, err_state, rows, _ = card_vs_cpu(
        tag, nodes_c, params_c, x, st_gpu, o_gpu, r_gpu)
    run_ms = []
    for _ in range(REPLAYS):
        t0 = time.perf_counter()
        plan.run(nodes, params, xg, device=DEV)
        sync()
        run_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"path [{tag}]: launches {counts}; card vs CPU: hidden spikes "
        f"{int(s_cpu.sum())} (rate {s_cpu.mean():.4f}), {n_ties} lanes "
        f"flipped at threshold ties, readout max abs err {err_plan:.3e}, "
        f"final states of {int(rows.sum())} undiverged rows max abs err "
        f"{err_state:.3e}; plan.run {np.median(run_ms):.3f} ms")
    return {"path": tag, "model": "bench_snn_engine shd_alif_ff "
            f"{N_IN}->{N_HIDDEN} ALIF->{N_OUT}", "T": ALIF_T, "batch": ALIF_B,
            "input": f"bernoulli({ALIF_RATE})", "launches": counts,
            "launches_per_run": per_run, "hidden_spikes": int(s_cpu.sum()),
            "hidden_rate": float(s_cpu.mean()), "tie_flips": n_ties,
            "rows_diverged": int((first_div < ALIF_T).sum()),
            "readout_max_abs_err": err_plan, "state_max_abs_err": err_state,
            "plan_run_ms_median": float(np.median(run_ms)),
            "plan_run_ms": run_ms, "card": smi}


# ---------------------------------------------------------------------------
# 6. compressed topology: the banded net streamed through the gather kernel
# ---------------------------------------------------------------------------


def phase_topology_banded(smi):
    """`bench_topology_exec`'s program through `plan.run_stream` on the
    card: BANDED_T steps in chunks of BANDED_CHUNK at batch 1."""
    from repro_torch.core import plan
    from repro_torch.kernels import registry
    tag = "topology_banded"
    nodes, params = make_banded(DEV)
    nodes_c, params_c = make_banded("cpu")
    x = banded_input()
    n_chunks = BANDED_T // BANDED_CHUNK

    def chunks(t_len):
        return (torch.from_numpy(x[i:i + BANDED_CHUNK]).to(DEV)
                for i in range(0, t_len, BANDED_CHUNK))

    def stream(t_len):
        outs = [o for _, o in plan.run_stream(nodes, params, chunks(t_len),
                                              device=DEV)]
        sync()
        return outs

    stream(BANDED_CHUNK)                                 # warm-up
    # -- peak device memory: streamed short and long, one-shot long --------
    peaks = {}
    for label, fn in (("stream_short", lambda: stream(BANDED_SHORT_T)),
                      ("stream_long", lambda: stream(BANDED_T)),
                      ("oneshot_long", lambda: plan.run(
                          nodes, params, torch.from_numpy(x).to(DEV),
                          device=DEV))):
        sync()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        fn()
        sync()
        peaks[label] = (torch.cuda.max_memory_allocated(), resident)
    ratio = peaks["stream_long"][0] / peaks["stream_short"][0]
    if not ratio <= STREAM_PEAK_RATIO:
        raise AssertionError(f"[{tag}] streamed peak device memory grows "
                             f"{ratio:.3f}x from T={BANDED_SHORT_T} to "
                             f"T={BANDED_T} (> {STREAM_PEAK_RATIO})")

    # -- the main path: launch counters from 0 --------------------------------
    registry.reset_launches()
    t0 = time.perf_counter()
    res = list(plan.run_stream(nodes, params, chunks(BANDED_T), device=DEV))
    sync()
    wall = time.perf_counter() - t0
    counts = registry.launch_counts()
    readout = {k: counts[k] for k in ("spikemm", "spikemm_sparse")}
    if sum(readout.values()) != n_chunks:
        raise AssertionError(f"[{tag}] readout INTEG launches {readout}, "
                             f"expected {n_chunks} in all")
    per_chunk = {"spikemm_gather": 1, "lif": 1, "linrec": 1}
    counted(tag, per_chunk, n_chunks,
            {k: v for k, v in counts.items() if k not in readout})
    streamed = torch.cat([o for _, o in res])
    st_stream = res[-1][0]

    # -- streamed equals one-shot, bit for bit --------------------------------
    st_gpu, o_gpu, r_gpu = plan.run(nodes, params,
                                    torch.from_numpy(x).to(DEV),
                                    record=("hidden",), device=DEV)
    if streamed.shape != (BANDED_T, 1, BANDED_OUT) or \
            not torch.isfinite(streamed).all():
        raise AssertionError(f"[{tag}] streamed outputs {streamed.shape}, "
                             f"expected finite {(BANDED_T, 1, BANDED_OUT)}")
    if not torch.equal(streamed, o_gpu):
        raise AssertionError(f"[{tag}] streamed outputs differ from one-shot "
                             f"plan.run by {float((streamed - o_gpu).abs().max()):.3e}")
    for node in st_gpu:
        for k in st_gpu[node]:
            if not torch.equal(st_stream[node][k], st_gpu[node][k]):
                raise AssertionError(f"[{tag}] streamed final state "
                                     f"{node}.{k} differs from one-shot")
    dev_ms, by_name = profile_ms(lambda: stream(BANDED_T))
    chunk_ms = wall * 1e3 / n_chunks
    replays = []
    for _ in range(BANDED_REPLAYS):
        t0 = time.perf_counter()
        stream(BANDED_T)
        replays.append((time.perf_counter() - t0) * 1e3 / n_chunks)
    log(f"path [{tag}]: {n_chunks} chunks streamed, launches {counts}; "
        f"streamed == one-shot plan.run, outputs and final state, bit for "
        f"bit; {chunk_ms:.3f} ms per chunk (replays "
        f"{', '.join(f'{r:.3f}' for r in replays)}), card time "
        f"{None if dev_ms is None else round(dev_ms / n_chunks, 4)} ms "
        f"per chunk")

    # -- the card against the CPU, under the tie rule -------------------------
    s_cpu, first_div, n_ties, err_plan, err_state, rows, err_rel = \
        card_vs_cpu(tag, nodes_c, params_c, x, st_gpu, o_gpu.cpu().numpy(),
                    r_gpu, tie_params={"w_input": banded_net()},
                    readout_rtol=BANDED_READOUT_RTOL)
    # the gather and lif equal their plain versions bit for bit, so the
    # card's hidden layer meets no threshold tie the CPU's does not
    if n_ties:
        raise AssertionError(f"[{tag}] {n_ties} hidden lanes flipped at "
                             "threshold ties; the gather and lif are bit "
                             "for bit their plain versions")
    log(f"path [{tag}]: card vs CPU: hidden spikes {int(s_cpu.sum())} "
        f"(rate {s_cpu.mean():.4f}), {n_ties} lanes flipped at threshold "
        f"ties, first divergence at step {int(first_div.min())} of "
        f"{BANDED_T}, readout max abs err {err_plan:.3e} (relative "
        f"{err_rel:.3e}), final state max abs err {err_state:.3e}; peak "
        f"device memory MB: streamed T={BANDED_SHORT_T} "
        f"{peaks['stream_short'][0] / 2**20:.1f}, T={BANDED_T} "
        f"{peaks['stream_long'][0] / 2**20:.1f} ({ratio:.4f}x), one-shot "
        f"T={BANDED_T} {peaks['oneshot_long'][0] / 2**20:.1f}")
    t = banded_net().lowering()
    return {"path": tag, "model": f"bench_topology_exec banded "
            f"{BANDED_N} LIF (sparse_coo band {BANDED_BAND}, w={BANDED_W}) "
            f"-> {BANDED_OUT} LI", "T": BANDED_T, "chunk": BANDED_CHUNK,
            "batch": 1, "input": f"bernoulli({BANDED_RATE})",
            "entries": int(len(t.jj)), "active_entries": t.n_entries,
            "launches": counts, "launches_per_window": {
                **per_chunk, **{k: v / n_chunks if v % n_chunks else
                                v // n_chunks for k, v in readout.items()}},
            "hidden_spikes": int(s_cpu.sum()),
            "hidden_rate": float(s_cpu.mean()), "tie_flips": n_ties,
            "first_divergence": int(first_div.min()),
            "readout_max_abs_err": err_plan,
            "readout_max_rel_err": err_rel, "state_max_abs_err": err_state,
            "stream_ms_per_chunk": chunk_ms,
            "stream_ms_per_chunk_replays": replays,
            "stream_ms_per_chunk_median": float(np.median(replays)),
            "device_ms_per_chunk": (None if dev_ms is None
                                    else dev_ms / n_chunks),
            "device_busy_share": (None if dev_ms is None
                                  else dev_ms / n_chunks / chunk_ms),
            "device_ms_per_chunk_by_kernel": top_per(by_name, n_chunks),
            "peak_bytes": {k: v[0] for k, v in peaks.items()},
            "resident_bytes_before": {k: v[1] for k, v in peaks.items()},
            "stream_peak_ratio": ratio, "card": smi}


def phase_sparse_tiles(cases):
    """The sparse product's CTA tile, measured: each timed sparse case
    launched at every tile of SPARSE_TILES (`launch_product`, uncounted)
    on flags measured once, each output equal to the wrapper's bit for
    bit, timed with `cuda_ms`. {case: {"T x T": ms, "plan": `sparse_tile`'s
    T}}."""
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.spikemm.sparse import (SPARSE_TILES,
                                                    launch_product,
                                                    occupancy_cuda,
                                                    sparse_tile,
                                                    spikemm_sparse_cuda)
    res = {}
    for case in cases:
        if not case.timed:
            continue
        s, w = case.args
        want = spikemm_sparse_cuda(s, w)
        flags, _ = occupancy_cuda(s)
        row = {"plan": sparse_tile(s.shape[0], w.shape[1],
                                   sm_count(s.device))}
        for tile in SPARSE_TILES:
            out = torch.empty_like(want)
            launch_product(s, w, flags, out, tile)
            sync()
            if not torch.equal(out, want):
                raise AssertionError(f"spikemm_sparse [{case.label}]: the "
                                     f"{tile} x {tile} tile differs from "
                                     "the wrapper's")
            row[f"{tile} x {tile}"] = cuda_ms(
                lambda: launch_product(s, w, flags, out, tile), iters=100)
        res[case.label] = row
        log(f"sparse product tile [{case.label}]: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()
                        if k != "plan")
            + f"; the plan takes {row['plan']}; all bit for bit")
    return res


# ---------------------------------------------------------------------------
# 7. block-sparse INTEG: eager plan.run on population-packed rasters
# ---------------------------------------------------------------------------


def phase_sparse_integ(smi):
    """`bench_snn_engine.run_sparsity_rows` on the card: one `plan.run` per
    density under `auto`, its channels read from the launch counters."""
    from repro_torch.core import plan
    from repro_torch.kernels import registry
    from repro_torch.kernels.spikemm.ops import (occupancy_fraction,
                                                 sparse_threshold)
    from repro_torch.kernels.spikemm.sparse import occupancy_cuda
    tag = "sparse_integ"
    env = "REPRO_SPIKEMM_SPARSE"
    nodes, params = make_sparse_integ(DEV)
    nodes_c, params_c = make_sparse_integ("cpu")
    T, B, K = SPARSE_T, SPARSE_B, SPARSE_IN
    saved = os.environ.pop(env, None)                    # auto
    rows = []
    try:
        plan.run(nodes, params, torch.zeros((4, B, K), device=DEV),
                 device=DEV)                             # warm-up
        sync()
        for d in SPARSE_DENSITIES:
            x = packed_raster(T * B, K, d, SPARSE_SEED).reshape(T, B, K)
            xg = torch.from_numpy(x).to(DEV)
            occ_in = occupancy_fraction(xg.reshape(T * B, K))
            registry.reset_launches()
            occupancy_cuda.launches = 0
            st_gpu, o_gpu, r_gpu = plan.run(nodes, params, xg,
                                            record=("hidden",), device=DEV)
            sync()
            counts = registry.launch_counts()
            # `auto` measures each INTEG's occupancy once, and a sparse
            # route takes the router's flags without measuring again
            occ_launches = occupancy_cuda.launches
            if occ_launches != 2:
                raise AssertionError(f"[{tag} {d}] {occ_launches} occupancy "
                                     "launches; one an INTEG expected")
            occ_ro = occupancy_fraction(r_gpu["hidden"].reshape(T * B, -1))
            th = sparse_threshold()
            route = {"input": "spikemm_sparse" if occ_in <= th else "spikemm",
                     "readout": "spikemm_sparse" if occ_ro <= th
                     else "spikemm"}
            per_run = {"lif": 1, "linrec": 1}
            for ch in route.values():
                per_run[ch] = per_run.get(ch, 0) + 1
            counted(f"{tag} {d}", per_run, 1, counts)
            # always == never (== auto) on the card, bit for bit
            runs = {}
            for mode in ("never", "always"):
                os.environ[env] = mode
                runs[mode] = plan.run(nodes, params, xg, record=("hidden",),
                                      device=DEV)
            del os.environ[env]
            for mode, (st, o, r) in runs.items():
                same = torch.equal(o, o_gpu) and torch.equal(
                    r["hidden"], r_gpu["hidden"]) and all(
                    torch.equal(st[n][k], st_gpu[n][k])
                    for n in st for k in st[n])
                if not same:
                    raise AssertionError(f"[{tag} {d}] {mode} differs from "
                                         "auto on the card")
            s_cpu, first_div, n_ties, err_plan, err_state, ok_rows, _ = \
                card_vs_cpu(f"{tag} {d}", nodes_c, params_c, x, st_gpu,
                            o_gpu.cpu().numpy(), r_gpu, floor=False)
            rate = float(s_cpu.mean())
            times = {"auto": [], "never": []}
            for _ in range(REPLAYS):
                for mode in ("never", "auto"):
                    if mode == "never":
                        os.environ[env] = mode
                    t0 = time.perf_counter()
                    plan.run(nodes, params, xg, device=DEV)
                    sync()
                    times[mode].append((time.perf_counter() - t0) * 1e3)
                    os.environ.pop(env, None)
            dev_ms, by_name = profile_ms(
                lambda: plan.run(nodes, params, xg, device=DEV))
            row = {"density": d, "input_occupancy": occ_in,
                   "readout_occupancy": occ_ro, "route": route,
                   "launches": counts, "occupancy_launches": occ_launches,
                   "hidden_rate": rate,
                   "counts_as_check": rate >= MIN_HIDDEN_RATE,
                   "tie_flips": n_ties,
                   "rows_diverged": int((first_div < T).sum()),
                   "readout_max_abs_err": err_plan,
                   "state_max_abs_err": err_state,
                   "plan_run_ms_median": float(np.median(times["auto"])),
                   "dense_plan_run_ms_median": float(
                       np.median(times["never"])),
                   "device_ms": dev_ms, "device_ms_by_kernel": top_per(
                       by_name, 1, n=6)}
            rows.append(row)
            log(f"path [{tag}] density {d}: occupancy {occ_in:.4f} (input), "
                f"{occ_ro:.4f} (readout) at the kernel's block -> {route}; "
                f"launches {counts}, occupancy {occ_launches}; always == "
                f"never == auto bit for bit; "
                f"card vs CPU: hidden rate {rate:.4f}"
                f"{'' if row['counts_as_check'] else ' (under the 1 % floor: this comparison does not count)'}"
                f", {n_ties} tie flips, {row['rows_diverged']} rows diverged, "
                f"readout max abs err {err_plan:.3e}; plan.run "
                f"{row['plan_run_ms_median']:.3f} ms (all dense "
                f"{row['dense_plan_run_ms_median']:.3f}), card time "
                f"{None if dev_ms is None else round(dev_ms, 4)} ms")
    finally:
        if saved is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = saved
    if not any(r["counts_as_check"] and r["route"]["input"] ==
               "spikemm_sparse" for r in rows):
        raise AssertionError(f"[{tag}] no density routed the input INTEG "
                             "sparse on a layer over the 1 % floor")
    total = {}
    for r in rows:
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    return {"path": tag, "model": f"dhsnn_shd homogeneous {SPARSE_IN}->"
            f"{SPARSE_HIDDEN}->20", "T": T, "batch": B,
            "input": f"packed rasters, seed {SPARSE_SEED}",
            "launches": total, "launches_per_run": {
                k: [r["launches"][k] for r in rows] for k in total},
            "densities": rows, "card": smi}


# ---------------------------------------------------------------------------
# 8. on-chip learning: plastic_ff, plastic_online, stdp_step
# ---------------------------------------------------------------------------


def hold_learned(tag, syn_gpu, rule, w0, pre, post, mod=None, syn0=None):
    """Hold a learned synapse state from the card to the CPU's per-step
    `synapse_run` fed with the card's own spike trains (pre, post on the
    card), from the same entry weight w0 (and entry state syn0), within
    LEARN_TOL; returns the largest error of each entry."""
    from repro_torch.core import plasticity
    ref = plasticity.synapse_run(
        rule, w0.cpu(), pre.cpu(), post.cpu(),
        mod=None if mod is None else torch.as_tensor(mod),
        syn=None if syn0 is None else {k: v.cpu() for k, v in syn0.items()})
    errs = {}
    for k, r in ref.items():
        got = syn_gpu[k].cpu()
        torch.testing.assert_close(got, r, rtol=LEARN_TOL, atol=LEARN_TOL,
                                   msg=lambda m: f"[{tag}] learned {k} card "
                                   f"vs CPU synapse_run: {m}")
        errs[k] = float((got - r).abs().max())
    return errs


def phase_plastic_ff(smi):
    """`bench_plasticity.measure_program`'s program through one learning
    `plan.run` per built-in rule on the card."""
    from repro_torch.core import plan, plasticity
    from repro_torch.kernels import registry
    tag = "plastic_ff"
    tie = load_tie_rule()
    env = "REPRO_SNN_ENGINE"
    saved = os.environ.pop(env, None)
    x = plastic_input()
    xg = torch.from_numpy(x).to(DEV)
    rows, total = [], {}
    try:
        for rule_name in PLASTIC_RULES:
            rtag = f"{tag} {rule_name}"
            rule = plasticity.make_synapse(rule_name)
            nodes, params = make_plastic(rule_name, DEV)
            nodes_c, params_c = make_plastic(rule_name, "cpu")
            compiled = plan.compile_program(nodes)
            want = (plan.PlasticLower("hidden", "input", plan.SYN_SEQ),)
            if compiled.plastic != want:
                raise AssertionError(f"[{rtag}] {compiled.describe()}")
            m = plastic_mod(rule_name)
            mg = None if m is None else torch.from_numpy(m).to(DEV)

            def run_once(record=(), learn=True):
                return plan.run(nodes, params, xg, record=record,
                                plan=compiled, mod=mg, learn=learn,
                                device=DEV)

            run_once()                                   # warm-up
            sync()
            w0 = params["hidden"]["w_input"].clone()
            # -- the main path: launch counters from 0 ----------------------
            registry.reset_launches()
            st, o, r = run_once(record=("hidden",))
            sync()
            counts = registry.launch_counts()
            per_run = {"spikemm": 2, "lif": 1, "linrec": 1 + len(rule.traces),
                       "stdp_seq": 1}
            counted(rtag, per_run, 1, counts)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            syn = st["hidden"]["syn:input"]
            if not torch.equal(params["hidden"]["w_input"], w0):
                raise AssertionError(f"[{rtag}] learning wrote into params")
            moved = float((syn["w"] - w0).abs().max())
            if not moved > 0:
                raise AssertionError(f"[{rtag}] nothing was learned")
            # -- the forward: card against the CPU, under the tie rule -------
            s_cpu, first_div, n_ties, err_plan, err_state, ok_rows, _ = \
                card_vs_cpu(rtag, nodes_c, params_c, x, st, o.cpu().numpy(),
                            r)
            # -- learning: the CPU's synapse_run on the card's trains -------
            errs = hold_learned(rtag, syn, rule, params_c["hidden"]["w_input"],
                                xg, r["hidden"], m)
            # -- the stepper engine learns the same ------------------------
            os.environ[env] = "stepper"
            try:
                st_s, _, r_s = run_once(record=("hidden",))
            finally:
                del os.environ[env]
            flips = int((r_s["hidden"] != r["hidden"]).sum())
            if flips:
                s_plan = r["hidden"].cpu().numpy()
                u, th = tie.hidden_membrane(
                    nodes_c[0], {"w_input": params_c["hidden"]["w_input"]
                                 .numpy()}, x, s_plan)
                tie.tie_rule(s_plan, r_s["hidden"].cpu().numpy(), u, th)
                step_errs = hold_learned(f"{rtag} stepper",
                                         st_s["hidden"]["syn:input"], rule,
                                         params_c["hidden"]["w_input"], xg,
                                         r_s["hidden"], m)
                err_step = max(step_errs.values())
            else:
                got = st_s["hidden"]["syn:input"]["w"]
                torch.testing.assert_close(got, syn["w"], rtol=0,
                                           atol=STEP_TOL)
                err_step = float((got - syn["w"]).abs().max())
            # -- learn=False launches no stdp_seq and changes no forward ----
            registry.reset_launches()
            st_f, o_f, _ = run_once(learn=False)
            sync()
            counted(f"{rtag} learn=False", {"spikemm": 2, "lif": 1,
                                            "linrec": 1}, 1,
                    registry.launch_counts())
            if st_f["hidden"]["syn:input"]["w"] is not params["hidden"][
                    "w_input"] or not torch.equal(o_f, o):
                raise AssertionError(f"[{rtag}] learn=False changed the "
                                     "synapse state or the forward")
            times = {"learn": [], "frozen": []}
            for _ in range(REPLAYS):
                for mode in times:
                    t0 = time.perf_counter()
                    run_once(learn=mode == "learn")
                    sync()
                    times[mode].append((time.perf_counter() - t0) * 1e3)
            dev_ms, by_name = profile_ms(run_once)
            row = {"rule": rule_name, "plan": compiled.describe(),
                   "launches": counts, "hidden_rate": float(s_cpu.mean()),
                   "tie_flips": n_ties,
                   "rows_diverged": int((first_div < PLASTIC_T).sum()),
                   "readout_max_abs_err": err_plan,
                   "state_max_abs_err": err_state,
                   "learned_max_abs_err": errs, "w_moved_max": moved,
                   "stepper_spike_flips": flips,
                   "stepper_w_max_abs_err": err_step,
                   "plan_run_ms_median": float(np.median(times["learn"])),
                   "plan_run_frozen_ms_median": float(
                       np.median(times["frozen"])),
                   "device_ms": dev_ms,
                   "device_ms_by_kernel": top_per(by_name, 1, n=8)}
            rows.append(row)
            log(f"path [{rtag}]: {compiled.describe()}; launches {counts}; "
                f"card vs CPU: hidden rate {row['hidden_rate']:.4f}, {n_ties} "
                f"tie flips, readout max abs err {err_plan:.3e}; learned vs "
                f"CPU synapse_run on the card's trains {errs}; stepper "
                f"engine: {flips} spike flips, w max abs err {err_step:.3e}; "
                f"learn=False launches no stdp_seq; plan.run "
                f"{row['plan_run_ms_median']:.3f} ms learning, "
                f"{row['plan_run_frozen_ms_median']:.3f} ms frozen, card "
                f"time {None if dev_ms is None else round(dev_ms, 4)} ms")
    finally:
        if saved is not None:
            os.environ[env] = saved
    return {"path": tag, "model": f"make_plastic_ff {PLASTIC_IN}->"
            f"{PLASTIC_HIDDEN}->{PLASTIC_OUT}", "T": PLASTIC_T,
            "batch": PLASTIC_B, "input": f"bernoulli({PLASTIC_RATE})",
            "launches": total, "launches_per_run": {
                k: [r["launches"][k] for r in rows] for k in total},
            "rules": rows, "card": smi}


def plastic_streams():
    """{sid: (steps, PLASTIC_IN)}: session i streams 96 + 8 * (i % 8) steps
    of Bernoulli(PLASTIC_RATE) spikes from numpy's generator with seed
    SERVE_PLASTIC_SEED."""
    x = (np.random.default_rng(SERVE_PLASTIC_SEED).random(
        (SERVE_PLASTIC_SESSIONS, 152, PLASTIC_IN)) < PLASTIC_RATE).astype(
            np.float32)
    return {f"s{i}": x[i, :96 + 8 * (i % 8)]
            for i in range(SERVE_PLASTIC_SESSIONS)}


@contextlib.contextmanager
def window_records(eng, windows):
    """Within it, each window `eng` serves appends to `windows` its live
    sessions in slot order ("sids"), their valid steps ("valid"), and on
    the host the input ("x"), each slot's plastic weight ("w") and hidden
    membrane ("v0") at the window's entry and the hidden layer's spike
    train ("hidden"): the engine's `plan.run` runs with
    record=("hidden",), which changes nothing it computes."""
    from repro_torch.core import plan as plan_mod
    real_run, real_cohort = plan_mod.run, eng._run_cohort
    cur = {}

    def run(*a, **kw):
        ns, out, rec = real_run(*a, **{**kw, "record": ("hidden",)})
        nodes, params, x = a[:3]
        mem = nodes[0].neuron.program.threshold.on
        windows.append({**cur, "x": x.cpu().numpy(),
                        "w": params["hidden"]["w_input"].cpu().numpy(),
                        "v0": kw["state"]["hidden"][mem].cpu().numpy(),
                        "hidden": rec["hidden"].cpu().numpy()})
        return ns, out, rec

    def cohort(c, states):
        cur.update(sids=[sess.sid for sess, _, _ in c],
                   valid=[v for _, _, v in c])
        return real_cohort(c, states)

    eng._run_cohort = cohort
    plan_mod.run = run
    try:
        yield
    finally:
        plan_mod.run = real_run
        del eng._run_cohort                 # the class's method again


def sessions_vs_cpu(tag, node, card, cpu):
    """Hold the card's learning windows (`window_records`) to the CPU's,
    session by session, under the threshold-tie rule: within a window a
    session's hidden train may differ from the CPU's only from a step where
    the CPU's float64 pre-reset membrane (from its entry membrane, through
    its own entry weight) lies within the tie margin of the threshold; from
    there the session has diverged. Returns {sid: the step of its stream
    where it diverged}, for the sessions that did."""
    tie = load_tie_rule()
    prog = node.neuron.program
    tau = prog.states[0].decay.value
    th = float(prog.threshold.base)
    if [w["sids"] for w in card] != [w["sids"] for w in cpu]:
        raise AssertionError(f"[{tag}] the card and the CPU served other "
                             "cohorts")
    done, diverged = {}, {}
    for wg, wc in zip(card, cpu):
        for i, (sid, n) in enumerate(zip(wg["sids"], wg["valid"])):
            t0 = done.get(sid, 0)
            done[sid] = t0 + n
            s_g, s_c = wg["hidden"][:n, i], wc["hidden"][:n, i]
            if sid in diverged or np.array_equal(s_g, s_c):
                continue
            x = wc["x"][:n, i].astype(np.float64)
            drive = x @ wc["w"][i].astype(np.float64)
            v = wc["v0"][i].astype(np.float64)
            u = np.zeros((n, len(v)))
            for t in range(n):
                u[t] = tau * v + drive[t]
                v = (u[t] - th * s_c[t] if prog.reset == "subtract"
                     else u[t] * (1.0 - s_c[t]))
            first, _ = tie.tie_rule(s_c[:, None], s_g[:, None], u[:, None],
                                    th)
            diverged[sid] = t0 + int(first[0])
    return diverged


def phase_serve_plastic(smi):
    """`EngineConfig(learn=True)` serving on the card: make_plastic_ff at
    PLASTIC_IN -> PLASTIC_HIDDEN -> PLASTIC_OUT with pair STDP, 128
    sessions, window 32, capacity 64, each session learning on its own
    weight through the session-batched spikemm and stdp_seq."""
    from repro_torch.kernels import registry
    from repro_torch.serve import EngineConfig, make_engine
    tag = "serve_plastic"
    nodes, params = make_plastic("pair_stdp", DEV)
    nodes_c, params_c = make_plastic("pair_stdp", "cpu")
    cfg = EngineConfig(window=WINDOW, capacity=CAPACITY, queue_limit=None,
                       learn=True)
    streams = plastic_streams()
    trace = make_trace(streams)
    w0 = params["hidden"]["w_input"].clone()
    per_window = {"spikemm_sessions": 1, "stdp_seq_sessions": 1,
                  "spikemm": 1, "lif": 1, "linrec": 3}

    # warm-up outside the measured run
    replay(make_engine(nodes, params, cfg, device=DEV),
           make_trace({k: v[:64] for k, v in list(streams.items())[:4]}))
    sync()

    # -- the main path: launch counters from 0 --------------------------------
    registry.reset_launches()
    lat, walls = [], []

    def timed_replay():
        t0 = time.perf_counter()
        e = replay(make_engine(nodes, params, cfg, device=DEV), trace, lat)
        sync()
        walls.append(time.perf_counter() - t0)
        return e

    eng = timed_replay()
    counts = registry.launch_counts()
    wins = eng.metrics.windows_run
    counted(tag, per_window, wins, counts)
    if not torch.equal(params["hidden"]["w_input"], w0):
        raise AssertionError(f"[{tag}] learning wrote into params")
    log(f"path [{tag}]: {len(streams)} sessions, {wins} windows, launches "
        f"{counts} ({per_window} per window)")

    # -- the card against the CPU engine, session by session -----------------
    card_w, cpu_w = [], []
    eng_g = make_engine(nodes, params, cfg, device=DEV)
    with window_records(eng_g, card_w):
        replay(eng_g, trace)
    eng_c = make_engine(nodes_c, params_c, cfg, device="cpu")
    with window_records(eng_c, cpu_w):
        replay(eng_c, trace)
    diverged = sessions_vs_cpu(tag, nodes_c[0], card_w, cpu_w)
    rate = float(np.mean([w["hidden"][:n, i].mean() for w in cpu_w
                          for i, n in enumerate(w["valid"])]))
    if rate < MIN_HIDDEN_RATE:
        raise AssertionError(f"[{tag}] hidden rate {rate:.4%} under the "
                             f"{MIN_HIDDEN_RATE:.0%} floor")
    err_out, err_w, err_tr, moved = 0.0, 0.0, 0.0, []
    for sid, v in streams.items():
        got = eng.outputs(sid)
        if got.shape != (len(v), PLASTIC_OUT) or not np.all(np.isfinite(got)):
            raise AssertionError(f"[{tag}] {sid}: outputs {got.shape}")
        if not np.array_equal(got, eng_g.outputs(sid)):
            raise AssertionError(f"[{tag}] {sid}: two card replays differ")
        t0 = diverged.get(sid, len(v))
        err_out = max(err_out, float(np.max(np.abs(
            got[:t0] - eng_c.outputs(sid)[:t0]), initial=0.0)))
        syn_g = eng.state_of(sid)["hidden"]["syn:input"]
        moved.append(float((syn_g["w"] - w0).abs().max()))
        if sid in diverged:
            continue
        syn_c = eng_c.state_of(sid)["hidden"]["syn:input"]
        for k, ref in syn_c.items():
            torch.testing.assert_close(syn_g[k].cpu(), ref, rtol=LEARN_TOL,
                                       atol=LEARN_TOL, msg=lambda m: (
                                           f"[{tag}] {sid} learned {k} card "
                                           f"vs CPU: {m}"))
            e = float((syn_g[k].cpu() - ref).abs().max())
            err_w, err_tr = ((max(err_w, e), err_tr) if k == "w"
                             else (err_w, max(err_tr, e)))
    if err_out > READOUT_TOL:
        raise AssertionError(f"[{tag}] readout card vs CPU {err_out:.3e} > "
                             f"{READOUT_TOL}")
    if not min(moved) > 0:
        raise AssertionError(f"[{tag}] a session learned nothing")
    log(f"path [{tag}]: card vs CPU engine: hidden rate {rate:.4f}, "
        f"{len(diverged)} sessions diverged at threshold ties {diverged}; "
        f"readout max abs err {err_out:.3e}; learned w max abs err "
        f"{err_w:.3e}, traces {err_tr:.3e} (the other "
        f"{len(streams) - len(diverged)} sessions); w moved "
        f"{min(moved):.3e}..{max(moved):.3e}")

    # -- one session solo against the full cohort ----------------------------
    solo_sid = next(iter(streams))
    solo = replay(make_engine(nodes, params, cfg, device=DEV),
                  [e for e in trace if e[1] == solo_sid])
    if not np.array_equal(solo.outputs(solo_sid), eng.outputs(solo_sid)):
        raise AssertionError(f"[{tag}] {solo_sid}: solo != cohort outputs")
    st_solo, st_cohort = solo.state_of(solo_sid), eng.state_of(solo_sid)
    for node, nd in st_solo.items():
        for k, v in nd.items():
            pairs = (v.items() if isinstance(v, dict) else [(None, v)])
            for e, t in pairs:
                other = st_cohort[node][k] if e is None \
                    else st_cohort[node][k][e]
                if not torch.equal(t.view(torch.int32),
                                   other.view(torch.int32)):
                    raise AssertionError(f"[{tag}] {solo_sid}: solo != "
                                         f"cohort state {node}.{k}.{e}")
    log(f"path [{tag}]: {solo_sid} solo == in the full cohort, outputs and "
        "state (learned synapses included) bit for bit")

    for _ in range(REPLAYS - 1):
        timed_replay()
    wall = float(np.median(walls))
    dev_ms, top = device_profile(
        lambda: make_engine(nodes, params, cfg, device=DEV), trace)
    host = host_breakdown(make_engine(nodes, params, cfg, device=DEV), trace)
    mean_ms = float(np.mean(lat)) * 1e3
    out = {"path": tag, "model": f"make_plastic_ff {PLASTIC_IN}->"
           f"{PLASTIC_HIDDEN}->{PLASTIC_OUT}, pair STDP, learn=True",
           "window": WINDOW, "capacity": CAPACITY, "sessions": len(streams),
           "windows": wins, "launches": counts,
           "launches_per_window": per_window,
           "input": f"bernoulli({PLASTIC_RATE})", "hidden_rate": rate,
           "sessions_diverged": diverged, "readout_max_abs_err": err_out,
           "learned_w_max_abs_err": err_w,
           "learned_traces_max_abs_err": err_tr,
           "w_moved_min": min(moved), "w_moved_max": max(moved),
           "replays": len(walls), "window_samples": len(lat),
           "p50_window_ms": float(np.percentile(lat, 50)) * 1e3,
           "p99_window_ms": float(np.percentile(lat, 99)) * 1e3,
           "mean_window_ms": mean_ms,
           "sessions_per_s": len(streams) / wall,
           "median_replay_wall_s": wall,
           "device_ms_per_window": dev_ms,
           "device_busy_share": (None if dev_ms is None
                                 else dev_ms / mean_ms),
           "device_ms_per_window_by_kernel": top,
           "host_ms_per_window_by_stage": host, "card": smi}
    mm_ms, mm_share = kernel_share(top, dev_ms, "spikemm_sessions_kernel")
    out["spikemm_sessions_ms_per_window"] = mm_ms
    out["spikemm_sessions_share"] = mm_share
    log(f"path [{tag}]: p50 window {out['p50_window_ms']:.3f} ms, p99 "
        f"{out['p99_window_ms']:.3f}, {out['sessions_per_s']:.1f} sessions/s, "
        f"card {dev_ms} ms a window, spikemm_sessions "
        + ("not in the trace's top kernels" if mm_ms is None
           else f"{mm_ms:.4f} ms of it ({mm_share:.1%})"))
    return out


# ---------------------------------------------------------------------------
# 10b. resilience
# ---------------------------------------------------------------------------

# the served SHD DH-SNN's faults: packet loss, dead rows and sign flips at
# once; the learning window's NaN-poisoned weight planes
RES_SHD_FAULTS = ("drop_blocks:p=0.2,seed=1;dead_rows:frac=0.1,seed=2;"
                  "bitflip:frac=1e-3,seed=3")
RES_LEARN_FAULTS = "nan_weights:frac=0.2"
RES_SESSIONS = 64
RES_TIMED = 3                 # timed replays of the trace per guard policy
# the stream checkpoint: windows of plastic_ff's plan.run, snapshots after
# the first RES_SNAPSHOTS of them
RES_WINDOWS, RES_SNAPSHOTS = 6, 3


def guard_events():
    """The guard incidents on the log, as (family, stage, error)."""
    from repro_torch.kernels.incidents import incidents
    return [(e.family, e.stage, e.error) for e in incidents(kind="guard")]


def sync_warnings(fn):
    """(fn's result, the host syncs it made), counted under
    `torch.cuda.set_sync_debug_mode("warn")`."""
    import warnings
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            r = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return r, sum("synchroniz" in str(w.message) for w in rec)


def bit_equal(a, b):
    """Two state or params trees equal bit for bit, leaf for leaf."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(bit_equal(a[k], b[k]) for k in a)
    return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b))


def session_trains(wins, sids, n):
    """(T_max, sessions, n): each session's recorded hidden train
    (`window_records`) over its whole stream, side by side."""
    parts = {sid: [] for sid in sids}
    for w in wins:
        for i, (sid, v) in enumerate(zip(w["sids"], w["valid"])):
            parts[sid].append(w["hidden"][:v, i])
    return side_by_side({sid: np.concatenate(p) for sid, p in parts.items()},
                        n)


def resilience_shd():
    """The served SHD DH-SNN under RES_SHD_FAULTS, guard sanitize then
    warn, card against CPU; a clean guard=off window against the clean
    path; host and card ms per window by policy."""
    import warnings

    from repro_torch.core import events, faults, plan
    from repro_torch.kernels import registry
    from repro_torch.kernels.incidents import clear
    from repro_torch.serve import EngineConfig, make_engine
    from repro_torch.weights import params_to_numpy
    tag = "resilience shd"
    tie = load_tie_rule()
    path = PATHS[0]
    nodes, params = make_shd(True, DEV)
    nodes_c, params_c = make_shd(True, "cpu")
    streams = shd_streams(RES_SESSIONS)
    trace = make_trace(streams)
    sids = list(streams)

    def cfg(guard):
        return EngineConfig(window=WINDOW, capacity=CAPACITY,
                            queue_limit=None, guard=guard)

    with faults.inject(RES_SHD_FAULTS), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        replay(make_engine(nodes, params, cfg("warn"), device=DEV),
               make_trace({k: v[:64] for k, v in list(streams.items())[:4]}))
        sync()
        # the faults' world on the host, for the tie rule's membrane: the
        # window's input mask (the same every window: the site is T x N) and
        # the perturbed weights
        mask = faults.perturb_input(torch.ones(WINDOW, 1, N_IN))[:, 0].numpy()
        hidden_np = params_to_numpy(faults.perturb_params(params_c))["hidden"]
        x = side_by_side(streams, N_IN)
        x_eff = x * np.tile(mask, (-(-len(x) // WINDOW), 1))[:len(x), None]
        runs = {}
        for guard in ("sanitize", "warn"):
            for where, nd, pr, dev in (("card", nodes, params, DEV),
                                       ("cpu", nodes_c, params_c, "cpu")):
                eng = make_engine(nd, pr, cfg(guard), device=dev)
                wins = []
                registry.reset_launches()
                clear()
                with window_records(eng, wins):
                    replay(eng, trace)
                runs[guard, where] = (eng, session_trains(wins, sids,
                                                          N_HIDDEN),
                                      guard_events(),
                                      registry.launch_counts())
            eng, s_gpu, inc_gpu, counts = runs[guard, "card"]
            eng_c, s_cpu, inc_cpu, _ = runs[guard, "cpu"]
            counted(f"{tag} {guard}", path.per_window,
                    eng.metrics.windows_run, counts)
            if inc_gpu != inc_cpu:
                raise AssertionError(f"[{tag} {guard}] card incidents "
                                     f"{inc_gpu} != CPU {inc_cpu}")
            steps = sum(len(v) for v in streams.values())
            rate = float(s_cpu.sum()) / (steps * N_HIDDEN)
            if rate < MIN_HIDDEN_RATE:
                raise AssertionError(f"[{tag} {guard}] hidden rate "
                                     f"{rate:.4%} under the floor")
            u, th = tie.hidden_membrane(nodes_c[0], hidden_np, x_eff, s_cpu)
            first_div, n_ties = tie.tie_rule(s_cpu, s_gpu, u, th)
            err = 0.0
            for b, sid in enumerate(sids):
                t0 = min(int(first_div[b]), len(streams[sid]))
                got, ref = eng.outputs(sid), eng_c.outputs(sid)
                if got.shape != ref.shape or not np.all(np.isfinite(got)):
                    raise AssertionError(f"[{tag} {guard}] {sid}: outputs "
                                         f"{got.shape}, CPU {ref.shape}")
                err = max(err, float(np.max(np.abs(got[:t0] - ref[:t0]),
                                            initial=0.0)))
            if err > READOUT_TOL:
                raise AssertionError(f"[{tag} {guard}] readout card vs CPU "
                                     f"{err:.3e} > {READOUT_TOL}")
            runs[guard] = dict(
                windows=eng.metrics.windows_run, launches=counts,
                incidents=len(inc_gpu), hidden_rate=rate, tie_flips=n_ties,
                rows_diverged=int((first_div < len(x)).sum()),
                readout_max_abs_err=err)
            log(f"path [{tag}]: guard={guard} under {RES_SHD_FAULTS}: "
                f"{eng.metrics.windows_run} windows, launches "
                f"{ {k: v for k, v in counts.items() if v} }, hidden rate "
                f"{rate:.4f}, {n_ties} lanes flipped at ties, readout card "
                f"vs CPU {err:.3e}, {len(inc_gpu)} guard incidents (the "
                "CPU's, in order)")
        # sanitize and warn differ only in what they do on a violation, and
        # this world has none (sign flips keep every value finite)
        for sid in sids:
            if not np.array_equal(runs["sanitize", "card"][0].outputs(sid),
                                  runs["warn", "card"][0].outputs(sid)):
                raise AssertionError(f"[{tag}] {sid}: sanitize and warn "
                                     "outputs differ with no violation")
    sanitize, warn = runs["sanitize"], runs["warn"]

    # -- guard=off with no fault: the clean path's launches and syncs --------
    with faults.inject(""):
        registry.reset_launches()
        eng = replay(make_engine(nodes, params, cfg("off"), device=DEV), trace)
        off_counts = registry.launch_counts()
        counted(f"{tag} off", path.per_window, eng.metrics.windows_run,
                off_counts)
        xw = torch.from_numpy(x[:WINDOW]).to(DEV)
        st = events.init_state(nodes, RES_SESSIONS, torch.float32, params,
                               device=DEV)

        def window(guard):
            return plan.run(nodes, params, xw, state=st, learn=False,
                            guard=guard, device=DEV, _traced=True)

        for g in (None, "off", "warn", "sanitize"):
            window(g)
        sync()
        syncs = {str(g): sync_warnings(lambda g=g: window(g))[1]
                 for g in (None, "off", "warn", "sanitize")}
        ops = {str(g): host_ops(lambda g=g: window(g))
               for g in (None, "off", "warn")}
        registry.reset_launches()
        window("off")
        one = registry.launch_counts()
        counted(f"{tag} off window", path.per_window, 1, one)
    if ops["off"] != ops["None"]:
        raise AssertionError(f"[{tag}] guard=off dispatched other ops than "
                             f"the clean window: {ops['off']} vs "
                             f"{ops['None']}")
    if syncs != {"None": 0, "off": 0, "warn": 1, "sanitize": 0}:
        raise AssertionError(f"[{tag}] host syncs of a window by guard "
                             f"{syncs}: off and sanitize should add none, "
                             "warn one")
    log(f"path [{tag}]: guard=off, no fault: {eng.metrics.windows_run} "
        f"windows with the clean path's launches ({path.per_window} a "
        f"window), a window's ops those of the clean window "
        f"({len(ops['off'])}; warn dispatches {len(ops['warn'])}), host "
        f"syncs a window {syncs}")

    # -- host and card ms a window, by policy --------------------------------
    lat = {g: [] for g in ("clean", "off", "warn", "sanitize")}
    card = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for _ in range(RES_TIMED):
            for g, samples in lat.items():
                with faults.inject("" if g == "clean" else RES_SHD_FAULTS):
                    replay(make_engine(nodes, params,
                                       cfg(None if g == "clean" else g),
                                       device=DEV), trace, samples)
        for g in lat:
            with faults.inject("" if g == "clean" else RES_SHD_FAULTS):
                card[g] = device_profile(lambda g=g: make_engine(
                    nodes, params, cfg(None if g == "clean" else g),
                    device=DEV), trace)
    host = {g: {"p50_window_ms": float(np.percentile(v, 50)) * 1e3,
                "mean_window_ms": float(np.mean(v)) * 1e3,
                "window_samples": len(v)} for g, v in lat.items()}
    for g in lat:
        what = ("no fault, no guard" if g == "clean"
                else f"guard={g} under the faults")
        log(f"path [{tag}]: {what}: host p50 {host[g]['p50_window_ms']:.3f} ms a window, mean "
            f"{host[g]['mean_window_ms']:.3f}; card {card[g][0]} ms a "
            f"window, by kernel {card[g][1]}")
    return {"faults": RES_SHD_FAULTS, "sanitize": sanitize, "warn": warn,
            "off_launches": off_counts, "off_windows": eng.metrics.windows_run,
            "syncs_per_window": syncs,
            "ops_per_window": {g: len(v) for g, v in ops.items()},
            "host_ms_per_window": host,
            "device_ms_per_window": {g: v[0] for g, v in card.items()},
            "device_ms_per_window_by_kernel": {g: v[1]
                                               for g, v in card.items()}}


def resilience_learning():
    """serve_plastic's model in one learning serve window of 64 sessions:
    under RES_LEARN_FAULTS with guard="sanitize" (finite, the CPU's
    weights and incidents), then clean with the explosion bound lowered
    between the sessions' learned-norm ratios, so that the sessions above
    it, and only they, roll back (sanitize) or are flagged (warn)."""
    import warnings

    from repro_torch.core import faults, guards
    from repro_torch.kernels import registry
    from repro_torch.kernels.incidents import clear
    from repro_torch.serve import EngineConfig, make_engine
    tag = "resilience learning"
    nodes, params = make_plastic("pair_stdp", DEV)
    nodes_c, params_c = make_plastic("pair_stdp", "cpu")
    streams = dict(list(plastic_streams().items())[:RES_SESSIONS])
    trace = make_trace(streams)
    per_window = {"spikemm_sessions": 1, "stdp_seq_sessions": 1,
                  "spikemm": 1, "lif": 1, "linrec": 3}

    def cfg(guard):
        return EngineConfig(window=WINDOW, capacity=CAPACITY,
                            queue_limit=None, learn=True, guard=guard)

    def w_of(eng, sid):
        return eng.state_of(sid)["hidden"]["syn:input"]["w"]

    out = {}
    with faults.inject(RES_LEARN_FAULTS):
        registry.reset_launches()
        clear()
        eng = replay(make_engine(nodes, params, cfg("sanitize"), device=DEV),
                     trace)
        counts = registry.launch_counts()
        counted(tag, per_window, eng.metrics.windows_run, counts)
        inc_gpu = guard_events()
        clear()
        eng_c = replay(make_engine(nodes_c, params_c, cfg("sanitize"),
                                   device="cpu"), trace)
        inc_cpu = guard_events()
    if inc_gpu != inc_cpu:
        raise AssertionError(f"[{tag}] card incidents {inc_gpu} != CPU "
                             f"{inc_cpu}")
    err = 0.0
    for sid in streams:
        w, w_c = w_of(eng, sid), w_of(eng_c, sid)
        if not bool(torch.isfinite(w).all()) or not np.all(
                np.isfinite(eng.outputs(sid))):
            raise AssertionError(f"[{tag}] {sid}: nonfinite weights or "
                                 "outputs under sanitize")
        torch.testing.assert_close(w.cpu(), w_c, rtol=LEARN_TOL,
                                   atol=LEARN_TOL, msg=lambda m: (
                                       f"[{tag}] {sid} learned w card vs "
                                       f"CPU: {m}"))
        err = max(err, float((w.cpu() - w_c).abs().max()))
    out["nan_weights"] = dict(faults=RES_LEARN_FAULTS,
                              windows=eng.metrics.windows_run,
                              launches=counts, incidents=len(inc_gpu),
                              learned_w_max_abs_err=err)
    log(f"path [{tag}]: {RES_LEARN_FAULTS} under sanitize: "
        f"{eng.metrics.windows_run} windows, launches "
        f"{ {k: v for k, v in counts.items() if v} }; every session's "
        f"weights and outputs finite, learned w card vs CPU {err:.3e}, "
        f"{len(inc_gpu)} guard incidents on both")

    # -- per-session rollback: one window, the bound between two sessions ----
    def learn_once(nd, pr, dev, guard):
        e = make_engine(nd, pr, cfg(guard), device=dev)
        for sid, xs in streams.items():
            e.open(sid)
            e.submit(sid, xs[:WINDOW])
            e.close(sid)
        clear()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            e.drain()
        return e, guard_events()

    with faults.inject(""):
        free, _ = learn_once(nodes, params, DEV, "off")
        w0 = params["hidden"]["w_input"]
        n0 = float(torch.linalg.vector_norm(w0.float()))
        ratio = {sid: float(torch.linalg.vector_norm(w_of(free, sid).float()))
                 / (n0 + 1.0) for sid in streams}
        r = sorted(ratio.values())
        k = max(range(len(r) // 4, 3 * len(r) // 4),
                key=lambda i: r[i + 1] - r[i])
        bound = (r[k] + r[k + 1]) / 2
        if not (r[k + 1] - r[k]) > 1e-5 * bound:
            raise AssertionError(f"[{tag}] no gap between the sessions' "
                                 f"norm ratios to put the bound in: {r}")
        rolled = {sid for sid, v in ratio.items() if v > bound}
        runs = {}
        for policy in ("sanitize", "warn"):
            g = guards.GuardConfig(policy=policy, w_ratio_max=bound)
            runs[policy] = (learn_once(nodes, params, DEV, g),
                            learn_once(nodes_c, params_c, "cpu", g))
    (san, inc_san), (san_c, _) = runs["sanitize"]
    for sid in streams:
        want = w0 if sid in rolled else w_of(free, sid)
        if not torch.equal(w_of(san, sid), want):
            raise AssertionError(f"[{tag}] {sid}: sanitize "
                                 + ("did not roll back" if sid in rolled
                                    else "changed a window it kept"))
        torch.testing.assert_close(w_of(san, sid).cpu(), w_of(san_c, sid),
                                   rtol=LEARN_TOL, atol=LEARN_TOL)
    (_, inc_warn), (_, inc_warn_c) = runs["warn"]
    flagged = [e for e in inc_warn if "explosion" in e[2]]
    if inc_san or len(flagged) != len(rolled) or inc_warn != inc_warn_c:
        raise AssertionError(f"[{tag}] incidents: sanitize {inc_san}, warn "
                             f"{inc_warn} (CPU {inc_warn_c}), "
                             f"{len(rolled)} sessions over the bound")
    if not 0 < len(rolled) < len(streams):
        raise AssertionError(f"[{tag}] {len(rolled)} of {len(streams)} "
                             "sessions over the bound: not a per-session "
                             "check")
    out["rollback"] = dict(w_ratio_max=bound, sessions=len(streams),
                           rolled_back=len(rolled),
                           ratio_min=r[0], ratio_max=r[-1])
    log(f"path [{tag}]: one window of {len(streams)} sessions, learned-norm "
        f"ratios {r[0]:.6f}..{r[-1]:.6f} of the entry's; with w_ratio_max "
        f"{bound:.6f} sanitize rolled back exactly the {len(rolled)} "
        f"sessions over it (entry weights bit for bit) and kept the "
        f"others' windows bit for bit, warn flagged those {len(flagged)} "
        "and the CPU the same")
    return out


def resilience_stream():
    """plastic_ff as a chunked-online plan.run stream of RES_WINDOWS
    windows (T=300, B=8) on the card, snapshotted by `StreamCheckpointer`
    after each of the first RES_SNAPSHOTS, restored into fresh (zero)
    templates and finished: the final params and state, bit for bit those
    of the uninterrupted card run."""
    import tempfile

    from repro_torch.core import events, faults, plan, plasticity
    from repro_torch.kernels import registry
    from repro_torch.train.checkpoint import StreamCheckpointer
    tag = "resilience stream"
    nodes, params0 = make_plastic("pair_stdp", DEV)

    def chunk(w):
        return torch.from_numpy((np.random.default_rng(30 + w).random(
            (PLASTIC_T, PLASTIC_B, PLASTIC_IN)) < PLASTIC_RATE).astype(
                np.float32)).to(DEV)

    def windows(nd, params, state, start, stop, ck=None):
        for w in range(start, stop):
            state, _, _ = plan.run(nd, params, chunk(w), state=state,
                                   device=DEV)
            params = plasticity.apply_learned(nd, params, state)
            if ck is not None:
                ck.save(w, state, params=params)
        return params, state

    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict) else torch.zeros_like(v)
                for k, v in tree.items()}

    with torch.no_grad(), faults.inject(""):
        st0 = events.init_state(nodes, PLASTIC_B, torch.float32, params0,
                                device=DEV)
        registry.reset_launches()
        p_ref, s_ref = windows(nodes, dict(params0), st0, 0, RES_WINDOWS)
        counts = registry.launch_counts()
        if counts["stdp_seq"] != RES_WINDOWS:
            raise AssertionError(f"[{tag}] {counts['stdp_seq']} stdp_seq "
                                 f"launches for {RES_WINDOWS} windows")
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            windows(nodes, dict(params0), st0, 0, RES_SNAPSHOTS,
                    StreamCheckpointer(d, keep=2))
            save_s = time.perf_counter() - t0
            nodes2, params2 = make_plastic("pair_stdp", DEV)
            t0 = time.perf_counter()
            window, state2, params2, _ = StreamCheckpointer(
                d, keep=2).restore_latest(zeros(st0), params=zeros(params2))
            restore_s = time.perf_counter() - t0
        if window != RES_SNAPSHOTS - 1:
            raise AssertionError(f"[{tag}] restored window {window}")
        p_res, s_res = windows(nodes2, params2, state2, window + 1,
                               RES_WINDOWS)
    if not (bit_equal(p_ref, p_res) and bit_equal(s_ref, s_res)):
        raise AssertionError(f"[{tag}] the resumed stream's params or state "
                             "differ from the uninterrupted run's")
    log(f"path [{tag}]: {RES_WINDOWS} windows (T={PLASTIC_T}, "
        f"B={PLASTIC_B}), snapshots after windows 0..{RES_SNAPSHOTS - 1} "
        f"({save_s:.3f} s with their runs), restored from window {window} "
        f"into zero templates ({restore_s:.3f} s) and finished: final "
        "weights, neuron states and synapse traces equal the "
        "uninterrupted card run bit for bit")
    return {"windows": RES_WINDOWS, "snapshots": RES_SNAPSHOTS,
            "restored_window": window, "launches": counts,
            "save_and_run_s": save_s, "restore_s": restore_s}


def phase_resilience(smi):
    """Runtime robustness on the card: faults, guards and stream
    checkpoints through the main path (`resilience_shd`,
    `resilience_learning`, `resilience_stream`)."""
    from repro_torch.kernels.incidents import clear
    shd = resilience_shd()
    learning = resilience_learning()
    stream = resilience_stream()
    clear()
    return {"path": "resilience", "model": PATHS[0].model,
            "window": WINDOW, "capacity": CAPACITY,
            "sessions": RES_SESSIONS,
            # the counted run: the served SHD DH-SNN, guard=off, no fault
            "launches": shd["off_launches"],
            "launches_per_window": PATHS[0].per_window,
            "shd": shd, "learning": learning, "stream": stream, "card": smi}


def phase_plastic_online(smi):
    """`examples/stdp_online.py`'s loop at the bench widths: ONLINE_CHUNKS
    chunks, chunked (apply_learned between chunks) and streamed
    (`run_stream`, the synapse state carried, the forward on the entry
    params)."""
    from repro_torch.core import plan, plasticity
    from repro_torch.kernels import registry
    tag = "plastic_online"
    rule = plasticity.pair_stdp(**ONLINE_RULE)
    nodes, params0 = make_plastic("pair_stdp", DEV, rule=rule)
    nodes_c, params_c = make_plastic("pair_stdp", "cpu", rule=rule)
    compiled = plan.compile_program(nodes)
    xs = [online_chunk(c) for c in range(ONLINE_CHUNKS)]
    xg = [torch.from_numpy(x).to(DEV) for x in xs]
    w0 = params0["hidden"]["w_input"].clone()
    plan.run(nodes, params0, xg[0][:8], plan=compiled, device=DEV)  # warm-up
    sync()
    per_chunk = {"spikemm": 2, "lif": 1, "linrec": 3, "stdp_seq": 1}

    # -- chunked: apply_learned between chunks, fresh traces each chunk ----
    registry.reset_launches()
    params, runs = params0, []
    t0 = time.perf_counter()
    for x in xg:
        st, _, r = plan.run(nodes, params, x, plan=compiled,
                            record=("hidden",), device=DEV)
        runs.append((params["hidden"]["w_input"], st, r["hidden"]))
        params = plasticity.apply_learned(nodes, params, st)
    sync()
    chunked_s = time.perf_counter() - t0
    drift, steps, rates, errs_c = [], [], [], []
    for c, (x, (w_in, st, s_hidden)) in enumerate(zip(xg, runs)):
        syn = st["hidden"]["syn:input"]
        errs_c.append(hold_learned(f"{tag} chunk {c}", syn, rule, w_in, x,
                                   s_hidden))
        steps.append(float(torch.linalg.norm(syn["w"] - w_in)))
        drift.append(float(torch.linalg.norm(syn["w"] - w0)))
        rates.append(float(s_hidden.mean()))
    counts_chunked = registry.launch_counts()
    counted(f"{tag} chunked", per_chunk, ONLINE_CHUNKS, counts_chunked)
    if not torch.equal(params0["hidden"]["w_input"], w0):
        raise AssertionError(f"[{tag}] learning wrote into the entry params")
    if not all(d > 0 for d in steps):
        raise AssertionError(f"[{tag}] a chunk learned nothing: |w_c - "
                             f"w_(c-1)| {steps}")

    # -- streamed: run_stream carries the synapse state ---------------------
    registry.reset_launches()
    t0 = time.perf_counter()
    res = list(plan.run_stream(nodes, params0, xg, plan=compiled,
                               device=DEV))
    sync()
    stream_s = time.perf_counter() - t0
    counts_stream = registry.launch_counts()
    counted(f"{tag} streamed", per_chunk, ONLINE_CHUNKS, counts_stream)
    # the stream's forward reads params0 throughout: its trains are those
    # of one frozen plan.run over the whole stream (checked on the outputs)
    x_all = np.concatenate(xs)
    xg_all = torch.cat(xg)
    st1, o1, r1 = plan.run(nodes, params0, xg_all, plan=compiled,
                           learn=False, record=("hidden",), device=DEV)
    if not torch.equal(torch.cat([o for _, o in res]), o1):
        raise AssertionError(f"[{tag}] streamed outputs differ from one "
                             "frozen plan.run over the stream")
    errs_s = hold_learned(f"{tag} streamed", res[-1][0]["hidden"]["syn:input"],
                          rule, w0, xg_all, r1["hidden"])
    s_cpu, first_div, n_ties, err_plan, err_state, _, _ = card_vs_cpu(
        f"{tag} forward", nodes_c, params_c, x_all, st1, o1.cpu().numpy(), r1)
    total = {k: counts_chunked[k] + counts_stream[k] for k in counts_stream}
    stream_drift = float(torch.linalg.norm(
        res[-1][0]["hidden"]["syn:input"]["w"] - w0))
    log(f"path [{tag}]: {ONLINE_CHUNKS} chunks of T={ONLINE_T}, B={ONLINE_B};"
        f" chunked: |w - w0| per chunk {[round(d, 4) for d in drift]} "
        f"(|w_c - w_(c-1)| {[round(d, 4) for d in steps]}), hidden "
        f"rate per chunk {[round(v, 4) for v in rates]}, learned vs CPU "
        f"replay max abs err {max(max(e.values()) for e in errs_c):.3e}; "
        f"streamed: |w - w0| {stream_drift:.4f}, learned vs CPU replay "
        f"{errs_s}; forward card vs CPU: {n_ties} tie flips, readout max abs "
        f"err {err_plan:.3e}; launches {total}; {chunked_s * 1e3:.1f} ms "
        f"chunked, {stream_s * 1e3:.1f} ms streamed")
    return {"path": tag, "model": f"make_plastic_ff {PLASTIC_IN}->"
            f"{PLASTIC_HIDDEN}->{PLASTIC_OUT}, pair_stdp({ONLINE_RULE})",
            "T": ONLINE_T, "batch": ONLINE_B, "chunks": ONLINE_CHUNKS,
            "input": "two alternating assemblies at 0.30 / 0.02",
            "launches": total, "launches_per_window": per_chunk,
            "drift_per_chunk": drift, "change_per_chunk": steps,
            "hidden_rate_per_chunk": rates,
            "learned_max_abs_err_chunked": errs_c,
            "learned_max_abs_err_streamed": errs_s,
            "stream_drift": stream_drift, "tie_flips": n_ties,
            "hidden_rate": float(s_cpu.mean()),
            "readout_max_abs_err": err_plan, "state_max_abs_err": err_state,
            "chunked_ms": chunked_s * 1e3, "streamed_ms": stream_s * 1e3,
            "card": smi}


def phase_stdp_step(smi):
    """`bench_plasticity.measure_rule_only`'s shapes through the legacy
    `stdp_run(use_kernel=True)`: one `stdp` launch per step."""
    from repro_torch.core import plasticity
    from repro_torch.kernels import registry
    tag = "stdp_step"
    cfg = plasticity.STDPConfig()
    pre, post, w = stdp_step_inputs()
    plasticity.stdp_run(cfg, w, pre[:4], post[:4], use_kernel=True)
    sync()
    registry.reset_launches()
    t0 = time.perf_counter()
    wk = plasticity.stdp_run(cfg, w, pre, post, use_kernel=True)
    sync()
    wall = (time.perf_counter() - t0) * 1e3
    counts = registry.launch_counts()
    counted(tag, {"stdp": PLASTIC_T}, 1, counts)
    we = plasticity.stdp_run(cfg, w, pre, post, use_kernel=False)
    torch.testing.assert_close(wk, we, rtol=STEP_TOL, atol=STEP_TOL)
    err = float((wk - we).abs().max())
    wc = plasticity.stdp_run(cfg, w.cpu(), pre.cpu(), post.cpu(),
                             use_kernel=True)
    torch.testing.assert_close(wk.cpu(), wc, rtol=STEP_TOL, atol=STEP_TOL)
    same_cpu = torch.equal(wk.cpu(), wc)
    moved = float((wk - w).abs().max())
    if not moved > 0:
        raise AssertionError(f"[{tag}] nothing was learned")
    times = {"kernel": [], "einsum": []}
    for _ in range(REPLAYS):
        for mode in times:
            t0 = time.perf_counter()
            plasticity.stdp_run(cfg, w, pre, post,
                                use_kernel=mode == "kernel")
            sync()
            times[mode].append((time.perf_counter() - t0) * 1e3)
    dev_ms, by_name = profile_ms(lambda: plasticity.stdp_run(
        cfg, w, pre, post, use_kernel=True))
    log(f"path [{tag}]: launches {counts}; kernel vs einsum stdp_run max abs "
        f"err {err:.3e}; card == CPU plain version bit for bit: {same_cpu}; "
        f"stdp_run {np.median(times['kernel']):.3f} ms with the kernel, "
        f"{np.median(times['einsum']):.3f} ms einsum, card time "
        f"{None if dev_ms is None else round(dev_ms, 4)} ms")
    return {"path": tag, "model": f"stdp_run {PLASTIC_IN}x{PLASTIC_HIDDEN}",
            "T": PLASTIC_T, "batch": PLASTIC_B,
            "input": f"bernoulli({PLASTIC_RATE})", "launches": counts,
            "launches_per_run": {"stdp": PLASTIC_T},
            "kernel_vs_einsum_max_abs_err": err, "equal_to_cpu": same_cpu,
            "w_moved_max": moved, "first_run_ms": wall,
            "stdp_run_ms_median": float(np.median(times["kernel"])),
            "einsum_stdp_run_ms_median": float(np.median(times["einsum"])),
            "device_ms": dev_ms,
            "device_ms_by_kernel": top_per(by_name, 1, n=8), "card": smi}


# ---------------------------------------------------------------------------
# 11. training: the SHD DH-SNN, forward and backward through the kernels
# ---------------------------------------------------------------------------


def train_data(device):
    """`examples/shd_dhsnn_torch.py`'s batch: gen_shd_spikes(48, T=60) as
    (T, B, n_in) spikes and (B,) labels on `device`."""
    from repro_torch.data.spikes import gen_shd_spikes
    xs, ys = gen_shd_spikes(TRAIN_B, T=TRAIN_T, n_in=N_IN)
    x = np.ascontiguousarray(xs.transpose(1, 0, 2))
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(ys).long().to(device))


def ecg_train_data(device):
    """`examples/ecg_srnn_torch.py`'s batch: gen_ecg_qtdb(16, T=200) as
    (T, B, 4) spikes and (T, B) band labels on `device`."""
    from repro_torch.data.spikes import gen_ecg_qtdb
    xs, ys = gen_ecg_qtdb(ECG_TRAIN_B, T=ECG_TRAIN_T)
    x = np.ascontiguousarray(xs.transpose(1, 0, 2))
    y = np.ascontiguousarray(ys.T)
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(y).long().to(device))


def shd_loss(outs, y):
    """Cross-entropy of the time-averaged readout (the SHD examples')."""
    return -torch.log_softmax(outs.mean(0), -1)[
        torch.arange(len(y), device=y.device), y].mean()


def ecg_loss(outs, y):
    """Per-timestep cross-entropy of the readout (the ECG examples')."""
    return -torch.log_softmax(outs, -1).gather(-1, y[..., None]).mean()


def param_leaves(tree, prefix=()):
    """[(path, tensor)] of a parameter tree, in sorted key order."""
    if isinstance(tree, dict):
        return [pt for k in sorted(tree)
                for pt in param_leaves(tree[k], prefix + (k,))]
    return [] if tree is None else [(prefix, tree)]


def with_grad(model):
    """A model's (nodes, params) with every parameter requiring grad."""
    nodes, params = model
    for _, p in param_leaves(params):
        p.requires_grad_()
    return nodes, params


def train_step(nodes, params, x, y, keep=False, loss_fn=shd_loss,
               lr=TRAIN_LR):
    """One step of an example's training through the user's entry point:
    the loss by `plan.run`, its backward, and the clipped SGD update at
    `lr`. Returns (the loss, {path: gradient} before the update where
    `keep`, else None)."""
    from repro_torch.core import plan
    _, outs, _ = plan.run(nodes, params, x, device=x.device)
    loss = loss_fn(outs, y)
    loss.backward()
    return loss.detach(), clipped_sgd(
        [("/".join(k), p) for k, p in param_leaves(params)], lr, keep)


def clipped_sgd(named, lr, keep):
    """The examples' update of the (name, leaf) pairs `named` from their
    `.grad`: p -= lr * min(1, 1 / |g|) * g, |g| the global norm, the
    grads cleared. Returns {name: gradient} before the update where
    `keep`, else None."""
    grads = ({k: p.grad.detach().clone() for k, p in named}
             if keep else None)
    gn = torch.sqrt(sum((p.grad ** 2).sum() for _, p in named))
    sc = torch.clamp_max(1.0 / (gn + 1e-9), 1.0)
    with torch.no_grad():
        for _, p in named:
            p -= lr * sc * p.grad
            p.grad = None
    return grads


@dataclasses.dataclass(frozen=True)
class TrainPath:
    """A training path: an example's data (`data(device)` -> (x, y)), loss
    and clipped-SGD update at `lr`, and its models, each (kind, the
    function making its (nodes, params) on a device with the weights of
    seed 0, its launches of one step)."""
    name: str
    describe: str
    input: str
    T: int
    B: int
    data: Callable
    loss: Callable
    lr: float
    models: tuple
    # forward_check(tag, make, x) -> the forward's card-vs-CPU report (see
    # `hidden_forward_vs_cpu`, the default)
    forward_check: Callable = None


def train_paths():
    """{name: TrainPath}. Launches of one step: train_shd, INTEG x2
    (spikemm), the branches' and the readout's linrec (the ablation: the
    readout's), the soma's lif; backward lif_bwd, a linrec_bwd per linrec,
    g_w x2 through spikemm_wgrad (under `auto`, the counted run's).
    train_ecg: INTEG x2, the hidden layer's alifrec (the ablation:
    lifrec), the readout's linrec; alifrec_bwd (lifrec_bwd), linrec_bwd,
    g_w x3 (input, recurrent, readout). train_alif_ff: INTEG x2, alif,
    linrec; alif_bwd, linrec_bwd, g_w x2. train_banded: the front INTEG
    and the readout's (spikemm x2), the band's gather forward
    (spikemm_gather) and its backward (B6, spikemm_gather_bwd: its own
    kernel on the transposed tables), lif x2 and lif_bwd x2,
    the readout's linrec and linrec_bwd, g_w x2 (w_input, w_hidden); the
    band has no weight gradient."""
    def shd(dendritic):
        n_lin = 2 if dendritic else 1
        return ("dendritic" if dendritic else "homogeneous",
                functools.partial(make_shd, dendritic),
                {"spikemm+sparse": 2, "spikemm_wgrad": 2, "lif": 1,
                 "linrec": n_lin, "lif_bwd": 1, "linrec_bwd": n_lin})

    def ecg(het):
        scan = "alifrec" if het else "lifrec"
        return ("heterogeneous" if het else "homogeneous",
                functools.partial(make_ecg, het),
                {"spikemm+sparse": 2, "spikemm_wgrad": 3, scan: 1,
                 f"{scan}_bwd": 1, "linrec": 1, "linrec_bwd": 1})
    shd_in = f"gen_shd_spikes({TRAIN_B}, T={TRAIN_T})"
    return {p.name: p for p in (
        TrainPath("train_shd", f"make_dhsnn_shd {N_IN}->{N_HIDDEN}x"
                  f"{N_BRANCHES} DH-LIF->{N_OUT} LI and its LIF ablation, "
                  f"clipped SGD lr {TRAIN_LR}", shd_in, TRAIN_T, TRAIN_B,
                  train_data, shd_loss, TRAIN_LR, (shd(True), shd(False))),
        TrainPath("train_ecg", f"make_srnn_ecg {ECG_IN}->{ECG_HIDDEN} "
                  f"self-recurrent ALIF->{ECG_OUT} LI and its recurrent-LIF "
                  f"ablation (sigmoid surrogate, alpha 4), clipped SGD lr "
                  f"{ECG_TRAIN_LR}",
                  f"gen_ecg_qtdb({ECG_TRAIN_B}, T={ECG_TRAIN_T})",
                  ECG_TRAIN_T, ECG_TRAIN_B, ecg_train_data, ecg_loss,
                  ECG_TRAIN_LR, (ecg(True), ecg(False))),
        TrainPath("train_alif_ff", f"the ALIF feed-forward program {N_IN}->"
                  f"{N_HIDDEN} ALIF(beta=0.5)->{N_OUT} LI(tau=0.97), clipped "
                  f"SGD lr {TRAIN_LR}", shd_in, TRAIN_T, TRAIN_B, train_data,
                  shd_loss, TRAIN_LR,
                  (("alif", make_alif_ff,
                    {"spikemm+sparse": 2, "spikemm_wgrad": 2, "alif": 1,
                     "alif_bwd": 1, "linrec": 1, "linrec_bwd": 1}),)),
        TrainPath("train_banded", f"{N_IN} -> {BANDED_N} LIF(0.8, 0.6) "
                  f"(w_input at {BANDED_FRONT_SCALE}/sqrt({N_IN})) -> "
                  f"{BANDED_N} LIF(0.8, 0.6) through the +-{BANDED_BAND} "
                  f"band at {BANDED_W} -> {BANDED_TRAIN_OUT} LI(0.9), "
                  f"clipped SGD lr {TRAIN_LR}",
                  f"gen_shd_spikes({BANDED_TRAIN_B}, T={BANDED_TRAIN_T})",
                  BANDED_TRAIN_T, BANDED_TRAIN_B, banded_train_data,
                  banded_loss, TRAIN_LR,
                  (("banded", make_train_banded,
                    {"spikemm+sparse": 2, "spikemm_wgrad": 2,
                     "spikemm_gather": 1, "spikemm_gather_bwd": 1, "lif": 2,
                     "lif_bwd": 2, "linrec": 1, "linrec_bwd": 1}),),
                  forward_check=banded_forward_vs_cpu))}


def hidden_forward_vs_cpu(tag, make, x):
    """The forward of the weights `make` draws, on the card and on the CPU:
    the hidden layer's trains under the tie rule (row-wise where
    recurrent), its lane-steps at a surrogate window edge and the readout
    before each row's first divergence. Returns {"rate": the CPU hidden
    rate, "first_div", "tie_flips", "readout_max_abs_err",
    "state_max_abs_err", "window_edges"}."""
    from repro_torch.core import plan
    from repro_torch.weights import params_to_numpy
    tie = load_tie_rule()
    xc = x.cpu()
    n0, p0 = make(DEV)
    nc0, pc0 = make("cpu")
    with torch.no_grad():
        st_g, o_g, r_g = plan.run(n0, p0, x, record=("hidden",), device=DEV)
        s_cpu, first_div, n_ties, err_out, err_state, _, _ = \
            card_vs_cpu(tag, nc0, pc0, xc.numpy(), st_g, o_g.cpu().numpy(),
                        r_g, floor=False)
    u, th = tie.hidden_membrane(nc0[0], params_to_numpy(pc0)["hidden"],
                                xc.numpy(), s_cpu)
    edges = int(tie.surrogate_edges(u, th, nc0[0].neuron.surrogate,
                                    nc0[0].neuron.alpha).sum())
    return {"rate": float(s_cpu.mean()), "first_div": first_div,
            "tie_flips": n_ties, "readout_max_abs_err": err_out,
            "state_max_abs_err": err_state, "window_edges": edges}


def banded_forward_vs_cpu(tag, make, x):
    """train_banded's forward on the card and on the CPU: the front layer's
    trains under the tie rule (its float64 membrane from the input), the
    band layer's in the rows where the front never diverged (its membrane
    from the CPU's front spikes through the band's tables), both layers at
    or over the 1 % floor, surrogate window edges counted in both, the
    readout within 1e-4 before each row's first divergence. Returns `hidden_forward_vs_cpu`'s report, its
    rate the band layer's, with "rates" of both layers."""
    from repro_torch.core import plan
    tie = load_tie_rule()
    xc = x.cpu()
    n0, p0 = make(DEV)
    nc0, pc0 = make("cpu")
    rec = ("front", "hidden")
    with torch.no_grad():
        _, o_g, r_g = plan.run(n0, p0, x, record=rec, device=DEV)
        _, o_c, r_c = plan.run(nc0, pc0, xc, record=rec, device="cpu")
    T = x.shape[0]
    s_front = r_c["front"].numpy()
    u_f, th_f = tie.hidden_membrane(
        nc0[0], {"w_input": pc0["front"]["w_input"].numpy()}, xc.numpy(),
        s_front)
    div_f, ties_f = tie.tie_rule(s_front, r_g["front"].cpu().numpy(), u_f,
                                 th_f)
    ok = div_f >= T
    s_hid = r_c["hidden"].numpy()
    u_h, th_h = tie.hidden_membrane(nc0[1], {"w_input": banded_net()},
                                    s_front, s_hid)
    div_h, ties_h = tie.tie_rule(s_hid[:, ok], r_g["hidden"].cpu().numpy()[
        :, ok], u_h[:, ok], th_h)
    first_div = div_f.copy()
    first_div[ok] = div_h
    o_c = o_c.numpy()
    err_out = tie.max_err_before(o_c, o_g.cpu().numpy(), first_div)
    if err_out > READOUT_TOL:
        raise AssertionError(f"[{tag}] readout card vs CPU {err_out:.3e} > "
                             f"{READOUT_TOL}")
    rates = {"front": float(s_front.mean()), "hidden": float(s_hid.mean())}
    if min(rates.values()) < MIN_HIDDEN_RATE:
        raise AssertionError(f"[{tag}] firing {rates}: a layer under the "
                             f"{MIN_HIDDEN_RATE:.0%} floor")
    edges = sum(int(tie.surrogate_edges(u, th, n.neuron.surrogate,
                                        n.neuron.alpha).sum())
                for u, th, n in ((u_f, th_f, nc0[0]), (u_h, th_h, nc0[1])))
    log(f"path [{tag}]: forward card vs CPU: firing {rates}, tie flips "
        f"front {ties_f}, band "
        f"{ties_h} in the {int(ok.sum())} rows whose front never diverged; "
        f"readout max abs err {err_out:.3e}")
    return {"rate": rates["hidden"], "rates": rates,
            "first_div": first_div,
            "tie_flips": ties_f + ties_h, "readout_max_abs_err": err_out,
            "state_max_abs_err": None, "window_edges": edges}


# the families whose backward is a kernel of its own (`KernelSpec.bwd`)
BWD_FAMILIES = ("lif", "linrec", "lifrec", "alif", "alifrec")


@contextlib.contextmanager
def recording(routes=None, bwd_calls=None):
    """Within it, each spikemm dispatch appends {raster, w, channel, args}
    to `routes` (the router's choice, its arguments as they came) and so
    does each g_w on the weight-gradient kernel's pair (channel
    `spikemm_wgrad`, marked `g_w`), and each backward kernel call its
    cloned (args, kwargs) to `bwd_calls[name]` (spikemm's weight gradient
    as `spikemm_wgrad`), through wrapped registry entries (restored after;
    the launch counters are not to be read inside)."""
    from repro_torch.kernels import registry
    registry.ensure_registered()        # the snapshot restored after is whole
    reg = registry._REGISTRY
    saved = dict(reg)

    def clone(t):
        # the compact storage of a stride-0 view, re-expanded: the kernel
        # is to see the strides the path handed it (a cloned (T, B, D)
        # view of an (N,) decay would be a full plane)
        if not torch.is_tensor(t):
            return t
        t = t.detach()
        keep = tuple(slice(0, 1) if st == 0 and n > 1 else slice(None)
                     for n, st in zip(t.shape, t.stride()))
        c = t[keep].clone().expand(t.shape)
        zero = [(n > 1 and st == 0) for n, st in zip(t.shape, t.stride())]
        if [(n > 1 and st == 0) for n, st in zip(c.shape, c.stride())] != \
                zero or not torch.equal(c, t):
            raise AssertionError(f"recording: a captured {tuple(t.shape)} "
                                 f"tensor of strides {t.stride()} was "
                                 f"cloned to strides {c.stride()}")
        return c
    try:
        if routes is not None:
            def select(*args, _route=registry.get("spikemm").select_channel,
                       **kw):
                choice, measured = _route(*args, **kw)
                routes.append({"raster": list(args[0].shape),
                               "w": list(args[1].shape),
                               "channel": "spikemm" if choice is None
                               else f"spikemm_{choice}", "args": args})
                return choice, measured
            reg["spikemm"] = dataclasses.replace(registry.get("spikemm"),
                                                 select_channel=select)
        for fam in ((BWD_FAMILIES + ("spikemm", "spikemm_gather"))
                    if routes is not None or bwd_calls is not None else ()):
            spec = registry.get(fam)
            name = spec.bwd_name or f"{fam}_bwd"

            def rec(*a, _fn=spec.bwd.cuda, _name=name, **kw):
                if bwd_calls is not None:
                    bwd_calls.setdefault(_name, []).append((
                        tuple(clone(t) for t in a),
                        {k: clone(v) for k, v in kw.items()}))
                if routes is not None and _name == "spikemm_wgrad":
                    R, K, N = wgrad_shape(a)
                    routes.append({"raster": [R, K], "w": [R, N],
                                   "channel": _name, "g_w": True,
                                   "args": a})
                return _fn(*a, **kw)
            reg[fam] = dataclasses.replace(
                spec, bwd=dataclasses.replace(spec.bwd, cuda=rec))
        yield
    finally:
        reg.clear()
        reg.update(saved)


def is_g_w(route, steps_rows):
    """Whether a spikemm dispatch is a weight gradient: the weight-gradient
    kernel's, or one on a transposed (K, T * B) raster (`steps_rows` =
    T * B)."""
    return route.get("g_w", False) or route["raster"][1] == steps_rows


def sigmoid_tols(kw):
    """(rtol, atol) of a backward call under the sigmoid surrogate (the
    kernels' expf), else (None, None): bit for bit."""
    if kw.get("surrogate") == "sigmoid":
        return SIGMOID_RTOL, SIGMOID_ATOL
    return None, None


def train_cases():
    """{kernel: [Case]} of the training steps. The backward kernels: each
    training path's calls of one step at full width (captured at the
    registry; timed; a kernel's calls from the first model that makes
    them are tagged with the path, the others with path_kind: the
    kernel-table rows are train_shd's dendritic step, train_ecg's
    heterogeneous step (lifrec_bwd: its ablation's) and train_alif_ff's);
    `lif_bwd` with every surrogate (alpha 0.5, 1, 2) and both resets at
    the JAX tests' (37, 3, 130), the JAX family's (20, 3, 130), T = 1 and
    0, ragged B x N (17 x 1 x 33, 5 x 3 x 7), and at T = SEG - 1, SEG,
    SEG + 1, 2 SEG + 5 and 300 (SEG the lane backward's segment) on the
    soma's 48 x 64 lanes and ragged 1 x 33, 3 x 7, 3 x 130, every
    surrogate, both resets, alpha 2; `linrec_bwd` at the JAX
    shapes (24, 3, 136) and (37, 3, 136) with a full decay plane, a
    stride-0 (T, B, D) view and a (D,) decay (g_a summed), each asked for
    every gradient, for g_x alone (the readout's) and for g_a and g_x, at
    T = 1 and 0 and ragged, and at `linrec_bwd_edge_cases()`; `lifrec_bwd`, `alifrec_bwd` and `alif_bwd` at
    `rec_bwd_cases()`. And spikemm's g_w products: `spikemm_wgrad` at
    every g_w call of the three paths' first models (captured at the
    registry; the ECG's recurrent one from s0 and the spikes plane),
    timed beside `torch.matmul` and the route it replaced, and at
    `wgrad_edge_cases()`; the dendritic SHD step's and the heterogeneous
    ECG step's also on the route it replaced, the (K, T * B) transposed
    rasters through the dense kernel and the sparse channel, timed beside
    `torch.matmul`."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.lif.ops import lif_cuda
    from repro_torch.kernels.linrec.ops import linrec_cuda
    out = {k: [] for k in BWD_SCANS + ("spikemm", "spikemm_sparse",
                                       "spikemm_wgrad",
                                       "spikemm_gather_bwd")}
    outs = (N_OUT, ECG_OUT)
    for path in train_paths().values():
        x, y = path.data(DEV)
        seen = set()
        for i, (kind, make, _) in enumerate(path.models):
            nodes, params = with_grad(make(DEV))
            calls, routes = {}, []
            with recording(routes, calls):
                train_step(nodes, params, x, y, loss_fn=path.loss,
                           lr=path.lr)
            sync()
            # the captured arguments keep the path's stride-0 views (the
            # clone asserts it for each): how many, by kernel
            views = {name: sum(
                1 for args, _ in got for t in args if torch.is_tensor(t)
                and any(n > 1 and st == 0
                        for n, st in zip(t.shape, t.stride())))
                for name, got in calls.items()}
            log(f"train cases [{path.name} {kind}]: captured backward "
                f"calls {({k: len(v) for k, v in calls.items()})}, "
                f"arguments kept as stride-0 views {views}")
            for name, got in calls.items():
                tag = path.name if name not in seen else \
                    f"{path.name}_{kind}"
                seen.add(name)
                if name == "spikemm_wgrad":
                    if i == 0:
                        out[name] += g_w_cases(path, got, outs)
                    continue
                if name == "spikemm_gather_bwd":
                    # B6: d_spikes of the band's input, beside one CSR
                    # torch.sparse.mm of the same product
                    bwd_csr = csr_product(banded_net(), transpose=True)
                    out[name] += [Case(
                        f"{tag} band d_spikes {tuple(a[0].shape)}", a,
                        path=tag, timed=True, library=bwd_csr(a[0]))
                        for a, _ in got]
                    continue
                for args, kw in got:
                    shape = tuple((args[1] if name == "linrec_bwd"
                                   else args[0]).shape)
                    what = ("soma" if kind == "dendritic" else "hidden") \
                        if name != "linrec_bwd" else (
                            "readout" if shape[2] in outs else "branches")
                    rtol, atol = sigmoid_tols(kw)
                    out[name].append(Case(f"{tag} {kind} {what} {shape}",
                                          args, path=tag, timed=True, kw=kw,
                                          rtol=rtol, atol=atol))
            if path.name == "train_banded":
                # the step's forward spike products (the front INTEG and
                # the readout's), on the channel `auto` routed, beside
                # torch.matmul; its g_w products are g_w_cases' above
                for r in routes:
                    if r.get("g_w"):
                        continue
                    args = tuple(a.detach() for a in r["args"])
                    front = args[1].shape[0] == N_IN
                    out[r["channel"]].append(Case(
                        f"train_banded {'front' if front else 'readout'} "
                        f"INTEG {tuple(args[0].shape)} @ "
                        f"{tuple(args[1].shape)}", args, path=path.name,
                        timed=True, rtol=None if front
                        else BANDED_READOUT_RTOL,
                        library=lambda a=args: torch.matmul(*a)))
            if i == 0 and path.name in ("train_shd", "train_ecg"):
                # the route it replaced: the spike product on the transposed
                # raster, through the dense kernel and the sparse channel
                for c in out["spikemm_wgrad"]:
                    if c.path != path.name:
                        continue
                    s = wgrad_raster(c.args, c.kw).t().contiguous()
                    gr = c.args[1]
                    for name in ("spikemm", "spikemm_sparse"):
                        out[name].append(Case(
                            c.label, (s, gr), path=path.name, timed=True,
                            library=lambda a=(s, gr): torch.matmul(*a)))
    g = torch.Generator().manual_seed(20)

    def rnd(*shape, lo=0.0, hi=1.0):
        return (lo + (hi - lo) * torch.rand(shape, generator=g)).to(DEV)

    def lif_case(label, T, B, N, reset, sur, alpha):
        hot = (torch.rand((B, N), generator=g) < 0.25).float() * 1.5
        cur = (0.6 * torch.randn((T, B, N), generator=g) + hot).to(DEV)
        tau, v0 = rnd(N, lo=0.7, hi=0.98), rnd(B, N, lo=-0.5, hi=0.9)
        s, _ = lif_cuda(cur, tau, v0, 1.0, reset)
        gs = torch.randn((T, B, N), generator=g).to(DEV)
        gv = torch.randn((B, N), generator=g).to(DEV)
        sig = sur == "sigmoid"
        out["lif_bwd"].append(Case(
            f"{label} ({T}, {B}, {N}), {reset} reset, {sur} alpha={alpha}",
            (cur, tau, v0, s, gs, gv, 1.0, sur, alpha, reset),
            rtol=SIGMOID_RTOL if sig else None,
            atol=SIGMOID_ATOL if sig else None, zero_ok=T == 0))

    for reset in ("zero", "subtract"):
        for sur in SURROGATES:
            for alpha in (0.5, 1.0, 2.0):
                lif_case("JAX tests' shape", 37, 3, 130, reset, sur, alpha)
        lif_case("JAX family's make_inputs", 20, 3, 130, reset,
                 "rectangle", 1.0)
        for T, B, N in ((1, 3, 130), (0, 3, 130), (17, 1, 33), (5, 3, 7)):
            lif_case("edge", T, B, N, reset, "rectangle", 1.0)
        # across the lane backward's segments: the soma's lanes and ragged
        # ones (not a multiple of 32 or of 4)
        seg = _build.LANE_BWD_SEG
        for T in (seg - 1, seg, seg + 1, 2 * seg + 5, 300):
            for B, N in ((TRAIN_B, N_HIDDEN), (1, 33), (3, 7), (3, 130)):
                for sur in SURROGATES:
                    lif_case("segment edge", T, B, N, reset, sur, 2.0)
    for T, B, D in ((24, 3, 136), (37, 3, 136), (1, 3, 136), (0, 3, 136),
                    (17, 1, 33)):
        x = torch.randn((T, B, D), generator=g).to(DEV)
        h0 = torch.randn((B, D), generator=g).to(DEV)
        a_d = rnd(D, lo=0.5, hi=0.99)
        for kind, a in (("full decay plane", rnd(T, B, D, lo=0.5, hi=0.99)),
                        ("stride-0 decay", a_d.expand(T, B, D)),
                        ("(D,) decay, g_a summed", a_d)):
            yv, _ = linrec_cuda(a, x, h0)
            gy = torch.randn((T, B, D), generator=g).to(DEV)
            ghT = torch.randn((B, D), generator=g).to(DEV)
            for need in ((True, True), (False, False), (True, False)):
                out["linrec_bwd"].append(Case(
                    f"({T}, {B}, {D}), {kind}, g_a {need[0]}, g_h0 "
                    f"{need[1]}", (a, yv, h0, gy, ghT),
                    kw=dict(need_a=need[0], need_h0=need[1]),
                    zero_ok=T == 0))
    out["linrec_bwd"] += linrec_bwd_edge_cases()
    for name, cases in rec_bwd_cases().items():
        out[name] += cases
    out["spikemm_wgrad"] += wgrad_edge_cases()
    return out


def linrec_bwd_edge_cases():
    """[Case] of `linrec_bwd` where its segments, buffers and lane maps
    have edges, each bit for bit its plain version: T = 1, SEG - 1, SEG +
    1, 2 SEG + 5, 4 SEG + 3 (more segments than buffers: the ring refills)
    and 300, on rows of 48 x 20 (the readouts'), 1 x 33 and 3 x 7 (not a
    multiple of 4 or 32 lanes) and 2 x 64 (groups of 32 columns, each
    summed by its last CTA), with a (D,) decay (g_a summed in the
    kernel, g_h0), a full decay plane (a plane of g_a, g_h0) and a
    stride-0 view (a plane of g_a, no g_h0); and the branch call, the
    soma's (T, B, N) cotangent read for K branches, at (48, 4, 64) (16-byte
    copies), (3, 3, 7) and (5, 2, 10) (lane copies), with and without
    g_hT, at T = 1, 60, 2 SEG + 5 and 300."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.linrec.ops import linrec_cuda
    g = torch.Generator().manual_seed(35)
    seg = _build.LANE_BWD_SEG
    out = []

    def rnd(*shape, lo=-1.0, hi=1.0):
        return (lo + (hi - lo) * torch.rand(shape, generator=g)).to(DEV)
    for T in (1, seg - 1, seg + 1, 2 * seg + 5, 4 * seg + 3, 300):
        for B, D in ((TRAIN_B, N_OUT), (1, 33), (3, 7), (2, 64)):
            x, h0 = rnd(T, B, D), rnd(B, D)
            a_d = rnd(D, lo=0.5, hi=0.99)
            for kind, a, need_h0 in (
                    ("(D,) decay, g_a summed", a_d, True),
                    ("full decay plane", rnd(T, B, D, lo=0.5, hi=0.99), True),
                    ("stride-0 decay", a_d.expand(T, B, D), False)):
                y, _ = linrec_cuda(a, x, h0)
                out.append(Case(
                    f"segment edge ({T}, {B}, {D}), {kind}, g_h0 {need_h0}",
                    (a, y, h0, rnd(T, B, D), rnd(B, D)),
                    kw=dict(need_a=True, need_h0=need_h0)))
    for T in (1, 60, 2 * seg + 5, 300):
        for B, K, N in ((TRAIN_B, N_BRANCHES, N_HIDDEN), (3, 3, 7),
                        (5, 2, 10)):
            D = K * N
            x, h0 = rnd(T, B, D), rnd(B, D)
            a = rnd(D, lo=0.5, hi=0.99)
            y, _ = linrec_cuda(a, x, h0)
            for with_hT in (True, False):
                out.append(Case(
                    f"branches ({T}, {B}, {K} x {N}), soma cotangent "
                    f"({T}, {B}, {N}), g_hT {with_hT}",
                    (a, y, h0, rnd(T, B, N), rnd(B, D) if with_hT
                     else None), kw=dict(need_a=True, need_h0=True)))
    return out


def g_w_cases(path, calls, outs):
    """[Case] of `spikemm_wgrad` at a training step's captured g_w calls
    (spikes, g, head=), timed beside `torch.matmul` on the raster's
    transpose (a view: the product PyTorch makes of it)."""
    cases = []
    for args, kw in calls:
        R, K, N = wgrad_shape(args)
        what = "readout" if N in outs else (
            "recurrent" if kw.get("head") is not None else "input")
        raster = wgrad_raster(args, kw)
        cases.append(Case(
            f"{path.name} g_w {what} ({K}, {R}) @ ({R}, {N})", args,
            path=path.name, timed=True, kw=kw,
            library=lambda a=(raster, args[1]): torch.matmul(a[0].t(),
                                                             a[1])))
    return cases


def wgrad_edge_cases():
    """[Case] of `spikemm_wgrad` at the edges of its split and its tiles:
    R = 0, 1, 31, 33 and ragged (R = 1000, 4097: not a multiple of the
    chunk), one chunk (R = 16) and 64 (R = 20000 at a small tile: a
    cluster's 8 CTAs of 8 groups), K = 1, 3, 7, 8, 9, 33 and 100 (under
    and over a tile's 8 to 64 rows; over 64 the 64-row tiles, walking
    their events at 32 columns; odd K takes the 4-byte copies), N = 1, 6,
    31, 32, 33, 64, 65, 129, 256 and 300 at K = 40 (the tiles small
    products spread over), K = 100 at N = 6 (a 64-row tile of four
    groups), 65 and 300 (the event walk at 128 and 256 columns), K = 32
    at N = 2048 (the dense route at 128 columns), a raster
    16-byte aligned with K % 4 == 0 and one that is not (a one-element
    offset), a shifted raster from `head` (the recurrent g_W's), an
    all-zero raster (the output +0 everywhere), a raster firing in every
    entry, and an input-like 4-column raster."""
    g = torch.Generator().manual_seed(29)
    out = []

    def case(label, R, K, N, rate=0.05, head=0, offset=0, silent=False):
        body = (torch.rand((R - head) * K + offset, generator=g)
                < rate).float().to(DEV)[offset:].view(R - head, K)
        gr = torch.randn((R, N), generator=g).to(DEV)
        kw = {}
        if head:
            kw["head"] = (torch.rand((head, K), generator=g)
                          < rate).float().to(DEV)
        out.append(Case(f"{label} ({K}, {R}) @ ({R}, {N})", (body, gr),
                        kw=kw, silent=silent or R == 0, zero_ok=R == 0))

    for R in (0, 1, 31, 33, 1000, 4097):
        case("rows", R, 64, 64)
    case("64 chunks", 20000, 8, 6)
    case("one chunk", 16, 700, 256)
    case("64-row tile of four groups", 1000, 100, 6, rate=0.1)
    for N in (65, 300):
        case("64-row event tile", 600, 100, N, rate=0.05)
    case("128-column tile", 300, 32, 2048, rate=0.1)
    for K in (1, 3, 7, 8, 9, 33, 100):
        case("k", 500, K, 20, rate=0.2)
    for N in (1, 6, 31, 32, 33, 64, 65, 129, 256, 300):
        case("n", 700, 40, N, rate=0.1)
    case("off 16-byte alignment", 640, 64, 64, offset=1)
    case("shifted raster from head", 48 * 30, 64, 64, head=48)
    case("all-zero raster", 2880, 64, 20, rate=0.0, silent=True)
    case("every entry fires", 600, 16, 48, rate=1.1)
    case("input-like", 3200, 4, 64, rate=0.3)
    return out


# the adaptation strength of the backward cases of the ALIF pair: the
# models' (ALIF(beta=0.5)); at the default 1.8 the adjoint grows a few
# fold a step under the sharp surrogates
BWD_BETA = 0.5


def rec_bwd_cases():
    """{kernel: [Case]} of `lifrec_bwd`, `alifrec_bwd` and `alif_bwd`
    beyond the training paths' calls, each from its own forward kernel's
    spikes: the JAX families' make_inputs shapes ((20, 3, 70) for lifrec,
    (20, 3, 130) for alif and alifrec, the block route); every surrogate
    at alpha 0.5, 1, 2 and 4 at a prime T = 37 from a nonzero v0, a0 and
    s0 (N = 70 for lifrec, 130 for the ALIF pair); the recurrent ones at
    the route edges and where the warp route's warps a row or W's place
    change, N = 31, 32, 33, 63, 64, 65, 96, 97, 127, 128, 129 and 1024 at
    B = 1, 3 and 64, at B = 15, 16, 17 (N = 64) and B = 301, 500, 1000
    (more rows, a block each, than SMs), at T = 2, 5, 31, 32, 33 and 65
    (N = 64) and 16, 17 (N = 128) (the edges of the warp route's chunks),
    and at N = 240 and 241 (the block route's W_rec in shared memory, then
    through L2); `alif_bwd` on lane rows of N = 6, 20 (B =
    64), 130 (B = 3) and 4097 (B = 1) at T = 1, 15, 16, 17 and 33; a wide
    row N = 2048 (T = 16, B = 16; timed: W_rec and W_rec^T through L2);
    T = 1 and T = 0; rows that fire in most steps. beta = BWD_BETA."""
    from repro_torch.kernels.alifrec.ops import alif_cuda, alifrec_cuda
    from repro_torch.kernels.lifrec.ops import lifrec_cuda
    g = torch.Generator().manual_seed(27)
    out = {"lifrec_bwd": [], "alifrec_bwd": [], "alif_bwd": []}

    def case(name, label, T, B, N, sur="rectangle", alpha=1.0, hot=0.25,
             state=True, timed=False, plain_iters=None):
        drive = (torch.rand((B, N), generator=g) < hot).float() * 1.2
        cur = (0.6 * torch.randn((T, B, N), generator=g) + drive).to(DEV)
        tau = (0.7 + 0.28 * torch.rand((N,), generator=g)).to(DEV)
        rho = (0.85 + 0.14 * torch.rand((N,), generator=g)).to(DEV)
        w = ((0.4 / N ** 0.5) * torch.randn((N, N), generator=g)).to(DEV)
        v0 = (0.3 * torch.randn((B, N), generator=g) * state).to(DEV)
        a0 = (0.5 * torch.rand((B, N), generator=g) * state).to(DEV)
        s0 = ((torch.rand((B, N), generator=g) < 0.3).float()
              * state).to(DEV)
        gs = torch.randn((T, B, N), generator=g).to(DEV)
        gv = torch.randn((B, N), generator=g).to(DEV)
        ga = torch.randn((B, N), generator=g).to(DEV)
        kw = dict(v_th=1.0, surrogate=sur, alpha=alpha)
        if name == "lifrec_bwd":
            s, _ = lifrec_cuda(cur, w, tau, v0, s0)
            args = (cur, w, tau, v0, s0, s, gs, gv)
        else:
            kw["beta"] = BWD_BETA
            if name == "alifrec_bwd":
                s = alifrec_cuda(cur, w, tau, rho, v0, a0, s0,
                                 beta=BWD_BETA)[0]
                args = (cur, w, tau, rho, v0, a0, s0, s, gs, gv, ga)
            else:
                s = alif_cuda(cur, tau, rho, v0, a0, beta=BWD_BETA)[0]
                args = (cur, tau, rho, v0, a0, s, gs, gv, ga)
        rtol, atol = sigmoid_tols(kw)
        out[name].append(Case(
            f"{label} ({T}, {B}, {N}), {sur} alpha={alpha}", args, kw=kw,
            timed=timed, rtol=rtol, atol=atol, zero_ok=T == 0,
            plain_iters=plain_iters))

    for name, n in (("lifrec_bwd", 70), ("alifrec_bwd", 130),
                    ("alif_bwd", 130)):
        case(name, "JAX family's make_inputs", 20, 3, n, state=False)
        for sur in SURROGATES:
            for alpha in (0.5, 1.0, 2.0, 4.0):
                case(name, "prime T, nonzero state", 37, 3, n, sur, alpha)
        for T in (1, 0):
            case(name, "edge", T, 3, 64)
        for n_hot in (64, 130):
            case(name, "rows firing in most steps", 37, 3, n_hot, hot=0.9)
    for name in ("lifrec_bwd", "alifrec_bwd"):
        for n in (31, 32, 33, 63, 64, 65, 96, 97, 127, 128, 129, 1024):
            for b in (1, 3, 64):
                case(name, "route edge", 37, b, n)
        # the warp route's launch, a block a row: B around the ECG's 16,
        # more rows than SMs, and step counts at the edges of the chunks
        # its helpers stage (32 steps; 16 above 64 neurons)
        for b in (15, 16, 17):
            case(name, "a block a row", 37, b, 64)
        for b, n in ((301, 64), (500, 33), (1000, 128)):
            case(name, "more rows than SMs", 37, b, n)
        for T in (2, 5, 31, 32, 33, 65):
            case(name, "chunk edge", T, 16, 64)
        for T in (16, 17):
            case(name, "chunk edge", T, 3, 128)
        for n in (BWD_SMEM_W_MAX_N, BWD_SMEM_W_MAX_N + 1):
            case(name, "block route's shared W_rec edge", 37, 3, n)
        case(name, "wide row", 16, 16, 2048, timed=True, plain_iters=1)
    for b, n in ((64, 6), (64, 20), (3, 130), (1, 4097)):
        for T in (1, 15, 16, 17, 33):
            case("alif_bwd", "lane edge", T, b, n)
    return out


def lif_bwd_alone(args, kw):
    """A launch of `lif_bwd_cuda(*args, **kw)`'s kernel alone, uncounted:
    the C entry on outputs and scratch allocated once (the kernel sums
    g_tau over B itself, so this is the wrapper without its
    allocations), g_tau with its scratch and g_v0 only where `kw` asks
    for them, as the wrapper computes them."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import optional_ptr, zeroed_counters
    from repro_torch.kernels.lif.ops import KERNEL_SURROGATES
    cur, tau, v0, s, gs, gv, *rest = args
    opts = {"v_th": 1.0, "surrogate": "rectangle", "alpha": 1.0,
            "reset": "zero"}
    opts.update(zip(opts, rest), **{k: v for k, v in kw.items()
                                    if k in opts})
    v_th, sur, alpha, reset = opts.values()
    need_tau, need_v0 = kw.get("need_tau", True), kw.get("need_v0", True)
    T, B, N = cur.shape
    gc = torch.empty_like(cur)
    gt = torch.empty_like(tau) if need_tau else None
    g0 = torch.empty_like(v0) if need_v0 else None
    segs = -(-T // _build.LANE_BWD_SEG)
    ckpt = torch.empty((segs, B, N), device=cur.device)
    stream = torch.cuda.current_stream().cuda_stream
    part = count = None
    if need_tau:
        part = torch.empty((B, N), device=cur.device)
        count = zeroed_counters(cur.device, stream, 1)
    lib = _build.library()

    def launch():
        _build.check("lif_bwd", lib.lif_bwd_f32(
            cur.data_ptr(), tau.data_ptr(), v0.data_ptr(), s.data_ptr(),
            gs.data_ptr(), gv.data_ptr(), ckpt.data_ptr(), optional_ptr(part),
            optional_ptr(count), gc.data_ptr(), optional_ptr(gt),
            optional_ptr(g0), T, B, N, float(v_th), int(reset == "subtract"),
            KERNEL_SURROGATES.index(sur), float(alpha), stream))
    return launch


# PyTorch ops that only allocate or view memory: no device work
_NO_KERNEL_OPS = ("aten.empty", "aten.empty_like", "aten.empty_strided",
                  "aten.view", "aten._unsafe_view", "aten._reshape_alias",
                  "aten.reshape", "aten.t", "aten.expand", "aten.slice",
                  "aten.select", "aten.as_strided", "aten.detach",
                  "aten.alias", "aten.unsqueeze", "aten.squeeze",
                  "aten.permute", "aten.transpose", "aten.lift_fresh")


def host_ops(fn):
    """The PyTorch ops `fn` dispatches that may run device work (those
    that only allocate or view memory left out), recorded on the host by a
    `TorchDispatchMode`: a check that needs no device tracer."""
    from torch.utils._python_dispatch import TorchDispatchMode
    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))

    with Record():
        fn()
    return [op for op in seen
            if op.rsplit(".", 1)[0] not in _NO_KERNEL_OPS]


def device_kernels(fn, traces=3):
    """The names of the device kernels `fn` runs, in launch order, traced
    with torch.profiler. A trace that holds no device event at all recorded
    nothing (the profiler's device tracing dropped it: `fn` launches at
    least one kernel), so it is traced again, up to `traces` times, after
    the allocator's cached blocks are released (the tracer's own device
    buffers need free memory); empty when none holds one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(traces):
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        evs = [ev for ev in prof.events()
               if ev.device_type == DeviceType.CUDA]
        if evs:
            break
        free, total = torch.cuda.mem_get_info()
        log(f"device_kernels: a trace with no device event and "
            f"{len(prof.events())} host events (free "
            f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB, PyTorch "
            f"reserves {torch.cuda.memory_reserved() / 2**30:.2f}); cached "
            "blocks released, traced again")
        torch.cuda.empty_cache()
    return [ev.name for ev in sorted(evs, key=lambda e: e.time_range.start)]


_GRAPH_STREAM = []


class _KernelNode(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (72 bytes, its CUfunction first)."""
    _fields_ = [("func", ctypes.c_void_p), ("gx", ctypes.c_uint),
                ("gy", ctypes.c_uint), ("gz", ctypes.c_uint),
                ("bx", ctypes.c_uint), ("by", ctypes.c_uint),
                ("bz", ctypes.c_uint), ("smem", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_nodes(fn):
    """The device work of one call of `fn`, read without the profiler: the
    call is captured in a CUDA graph and the graph's nodes listed through
    the driver (`cuGraphGetNodes`): [(mangled kernel name, its
    `_KernelNode` params, its static shared memory)] for a kernel node,
    [(node type, None, None)] for any other. A call on the capture stream
    goes first, so that what `fn` makes once for a stream (its zeroed
    counters) is not made inside the capture."""
    cu = ctypes.CDLL("libcuda.so.1")

    def check(code, what):
        if code:
            raise AssertionError(f"graph_nodes: {what} returned {code}")
    if not _GRAPH_STREAM:
        _GRAPH_STREAM.append(torch.cuda.Stream())
    side = _GRAPH_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    sync()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        fn()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value != 0:                   # CU_GRAPH_NODE_TYPE_KERNEL
            out.append((kind.value, None, None))
            continue
        p = _KernelNode()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                               ctypes.byref(p)),
              "cuGraphKernelNodeGetParams_v2")
        name = ctypes.c_char_p()
        check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func)),
              "cuFuncGetName")
        static = ctypes.c_int(0)   # CU_FUNC_ATTRIBUTE_SHARED_SIZE_BYTES (1)
        check(cu.cuFuncGetAttribute(ctypes.byref(static), 1,
                                    ctypes.c_void_p(p.func)),
              "cuFuncGetAttribute")
        out.append((name.value.decode(), p, static.value))
    del graph
    return out


def graph_kernels(fn):
    """The names of the device work of one call of `fn` (`graph_nodes`):
    a kernel node by its name, any other node by its type."""
    return [name if p is not None else f"graph node of type {name}"
            for name, p, _ in graph_nodes(fn)]


def alif_bwd_alone(args, kw):
    """A launch of `alif_bwd_cuda(*args, **kw)`'s kernel alone, uncounted:
    the C entry on outputs and scratch allocated once (the kernel sums
    g_tau and g_rho over B itself, so this is the wrapper without its
    allocations)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import zeroed_counters
    from repro_torch.kernels.lif.ops import KERNEL_SURROGATES
    cur, tau, rho, v0, a0, s, gs, gv, ga = args[:9]
    opts = {"v_th": 1.0, "beta": 1.8, "surrogate": "rectangle",
            "alpha": 1.0}
    opts.update(zip(opts, args[9:]), **{k: v for k, v in kw.items()
                                         if k in opts})
    v_th, beta, sur, alpha = opts.values()
    T, B, N = cur.shape
    gc = torch.empty_like(cur)
    gt, gr = torch.empty_like(tau), torch.empty_like(rho)
    g0, a0g = torch.empty_like(v0), torch.empty_like(a0)
    segs = -(-T // _build.LANE_BWD_SEG)
    ckpt = torch.empty((segs, 2, B, N), device=cur.device)
    part = torch.empty((2, B, N), device=cur.device)
    stream = torch.cuda.current_stream().cuda_stream
    count = zeroed_counters(cur.device, stream, 1)
    lib = _build.library()

    def launch():
        _build.check("alif_bwd", lib.alif_bwd_f32(
            cur.data_ptr(), tau.data_ptr(), rho.data_ptr(), v0.data_ptr(),
            a0.data_ptr(), s.data_ptr(), gs.data_ptr(), gv.data_ptr(),
            ga.data_ptr(), ckpt.data_ptr(), part.data_ptr(),
            count.data_ptr(), gc.data_ptr(), gt.data_ptr(), gr.data_ptr(),
            g0.data_ptr(), a0g.data_ptr(), T, B, N, float(v_th),
            float(beta), KERNEL_SURROGATES.index(sur), float(alpha),
            stream))
    return launch


def linrec_bwd_flipped(label, args, gx):
    """The JAX package's own route to gx: the forward recurrence on the
    time-reversed decay shifted by one step (a_T = 0), g_hT (zero where
    None) folded into the last step, from 0, here through `linrec.cu`'s
    forward kernel, on the K-fold plane of a soma's cotangent; it must
    equal the backward kernel's gx bit for bit."""
    from repro_torch.kernels.linrec.ops import linrec_cuda
    a, y, h0, gy, ghT = args
    T, B, D = y.shape
    ae = a.expand(y.shape)
    a_rev = torch.cat([ae[1:], torch.zeros_like(ae[:1])]).flip(0)
    N = gy.shape[2]                 # the soma's cotangent for K = D / N
    gy1 = gy[:, :, None, :].expand(T, B, D // N, N).reshape(T, B, D).clone()
    gy1[-1] = gy1[-1] + (torch.zeros_like(h0) if ghT is None else ghT)
    rev, _ = linrec_cuda(a_rev.contiguous(), gy1.flip(0).contiguous(),
                         torch.zeros_like(h0))
    if not same_bits("linrec_bwd", rev.flip(0), gx):
        raise AssertionError(f"linrec_bwd [{label}]: gx differs from the "
                             "forward kernel on the flipped decay")
    return "; gx == the forward kernel on the flipped decay, bit for bit"


# PyTorch ops that may serve a DH-LIF branch call's backward: the fills,
# slice copies, adds and sums the autograd of a branch sum over a (T, B, K,
# N) plane makes (`branch_call_ops`)
BRANCH_OPS = ("aten::fill_", "aten::zero_", "aten::zeros", "aten::zeros_like",
              "aten::new_zeros", "aten::copy_", "aten::add", "aten::add_",
              "aten::sum", "aten::sum_to_size", "aten::select_backward",
              "aten::clone", "aten::contiguous")
# the DH-SNN's w_tau_d (the branch decay's parameter) card vs CPU, a
# relative L2 error
TAU_D_RTOL = 1e-4


def branch_call_ops(fn, T, B, K, N):
    """The PyTorch ops of one call of `fn` (a DH-SNN training step) that
    serve its branch call: a BRANCH_OPS op with an input of the branches'
    shapes ((T, B, K, N), (T, B, K N), (B, K N)) or under an
    `aten::select_backward`, traced with torch.profiler (record_shapes).
    [{"op", "shapes", "calls", "card_ms"}], an op's card time its kernels'
    (an op under another listed one counted there)."""
    from torch.profiler import ProfilerActivity, profile
    shapes = ([T, B, K, N], [T, B, K * N], [B, K * N])
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        sync()

    def under_select(ev):
        if ev.name == "aten::select_backward":
            return ev
        p = ev.cpu_parent
        while p is not None:
            if p.name == "aten::select_backward":
                return p
            p = p.cpu_parent
        return None
    found = {}
    for ev in prof.events():
        if ev.name not in BRANCH_OPS:
            continue
        top = under_select(ev)
        if top is None and not any(list(sh) in shapes
                                   for sh in ev.input_shapes):
            continue
        key = (ev.name, str([list(sh) for sh in ev.input_shapes]))
        row = found.setdefault(key, {"op": ev.name, "shapes": key[1],
                                     "calls": 0, "card_ms": 0.0})
        row["calls"] += 1
        p, counted_above = ev.cpu_parent, False
        while p is not None:
            if p.name in BRANCH_OPS and (
                    under_select(p) is not None or any(
                        list(sh) in shapes for sh in p.input_shapes)):
                counted_above = True
                break
            p = p.cpu_parent
        if not counted_above:
            row["card_ms"] += ev.device_time_total / 1e3
    return sorted(found.values(), key=lambda r: -r["card_ms"])


def rel_l2(got, ref):
    ref = ref.double()
    return float((got.double() - ref).norm() / ref.norm().clamp_min(1e-30))


def phase_train(path, smi):
    """TRAIN_STEPS clipped-SGD steps of each of the path's models at the
    published widths, forward and backward through `plan.run` on the
    card."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.common import rec_route_launch_counts
    from repro_torch.kernels.spikemm import sparse
    tie = load_tie_rule()
    tag = path.name
    x, y = path.data(DEV)
    xc, yc = x.cpu(), y.cpu()
    step = functools.partial(train_step, loss_fn=path.loss, lr=path.lr)
    models, total, per_run = {}, {}, {}
    for kind, make, want in path.models:
        nodes, params = with_grad(make(DEV))
        sync()
        routes0 = rec_route_launch_counts()
        registry.reset_launches()
        occ0 = sparse.occupancy_cuda.launches
        steps = [step(nodes, params, x, y, keep=i == 0)
                 for i in range(TRAIN_STEPS)]
        sync()
        counts = registry.launch_counts()
        occ = sparse.occupancy_cuda.launches - occ0
        losses = [float(loss) for loss, _ in steps]
        log(f"path [{tag}] {kind}: losses {losses}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"[{tag}] {kind}: a loss is not finite")
        mm = counts["spikemm"] + counts["spikemm_sparse"]
        rest = {k: v for k, v in counts.items()
                if k not in ("spikemm", "spikemm_sparse")}
        counted(f"{tag} {kind}", {k: v for k, v in want.items()
                                  if k != "spikemm+sparse"},
                TRAIN_STEPS, rest)
        if mm != want["spikemm+sparse"] * TRAIN_STEPS:
            raise AssertionError(f"[{tag}] {kind}: {mm} spikemm launches "
                                 f"(both channels), want "
                                 f"{want['spikemm+sparse'] * TRAIN_STEPS}")
        # under auto one occupancy measure a forward INTEG, none for a g_w
        if occ != want["spikemm+sparse"] * TRAIN_STEPS:
            raise AssertionError(f"[{tag}] {kind}: {occ} occupancy launches, "
                                 "want one a forward INTEG and none a g_w")
        routes = rec_routes_taken(f"{tag} {kind}", routes0, counts,
                                  nodes[0].out_dim)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
            per_run[k] = max(per_run.get(k, 0), v // TRAIN_STEPS)
        # the first step against the CPU's, from the same weights
        nodes_c, params_c = with_grad(make("cpu"))
        loss_c, grads_c = step(nodes_c, params_c, xc, yc, keep=True)
        grads_g = steps[0][1]
        loss_err = abs(losses[0] - float(loss_c)) / abs(float(loss_c))
        leaf_err = {k: rel_l2(grads_g[k].cpu(), v)
                    for k, v in grads_c.items()}
        if not loss_err <= TRAIN_LOSS_RTOL or not max(
                leaf_err.values()) <= TRAIN_LEAF_RTOL:
            raise AssertionError(
                f"[{tag}] {kind}: first step card vs CPU: loss relative "
                f"{loss_err:.3e} (tol {TRAIN_LOSS_RTOL}), leaves {leaf_err} "
                f"(tol {TRAIN_LEAF_RTOL})")
        # the forward's hidden trains under the tie rule (row-wise where
        # recurrent), and the hidden lane-steps at a surrogate window edge
        fwd = (path.forward_check or hidden_forward_vs_cpu)(
            f"{tag} {kind}", make, x)
        first_div, n_ties = fwd["first_div"], fwd["tie_flips"]
        err_out, err_state = (fwd["readout_max_abs_err"],
                              fwd["state_max_abs_err"])
        edges = fwd["window_edges"]
        # the first step again under each channel setting: g_w crosses
        # the dense and the sparse kernel whatever `auto` picks
        channels, first = {}, {}
        for mode in ("auto", "never", "always"):
            nm, pm = with_grad(make(DEV))
            taken = []
            old = os.environ.get("REPRO_SPIKEMM_SPARSE")
            os.environ["REPRO_SPIKEMM_SPARSE"] = mode
            try:
                with recording(taken):
                    lm, gm = step(nm, pm, x, y, keep=True)
            finally:
                if old is None:
                    os.environ.pop("REPRO_SPIKEMM_SPARSE")
                else:
                    os.environ["REPRO_SPIKEMM_SPARSE"] = old
            channels[mode] = [
                {"call": "g_w" if is_g_w(r, path.T * path.B) else "forward",
                 "raster": r["raster"], "w": r["w"],
                 "channel": r["channel"]} for r in taken]
            first[mode] = (float(lm), gm)
            log(f"path [{tag}] {kind} first step under {mode}: "
                + "; ".join(f"{c['call']} {c['raster']}@{c['w']} -> "
                            f"{c['channel']}" for c in channels[mode]))
        # g_w: the weight-gradient kernel under auto and never, the sparse
        # channel under always (which pins it)
        gw = {m: {c["channel"] for c in channels[m] if c["call"] == "g_w"}
              for m in channels}
        if gw != {"auto": {"spikemm_wgrad"}, "never": {"spikemm_wgrad"},
                  "always": {"spikemm_sparse"}}:
            raise AssertionError(f"[{tag}] {kind}: g_w took {gw}")
        same = {m: first[m][0] == losses[0] and all(
            torch.equal(first[m][1][k], grads_g[k]) for k in grads_g)
            for m in first}
        for m, (lm, gm) in first.items():
            if not abs(lm - losses[0]) <= TRAIN_LOSS_RTOL * abs(losses[0]) \
                    or not all(rel_l2(gm[k], grads_g[k]) <= TRAIN_LEAF_RTOL
                               for k in grads_g):
                raise AssertionError(f"[{tag}] {kind}: the first step under "
                                     f"{m} differs from the counted run's")
        # the step's time, forward + backward + update, by host clock
        nt, pt = with_grad(make(DEV))
        for _ in range(TRAIN_WARMUP):
            step(nt, pt, x, y)
        sync()
        step_ms = []
        for _ in range(TRAIN_TIMED):
            t0 = time.perf_counter()
            step(nt, pt, x, y)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        card_ms, by_name = profile_ms(lambda: step(nt, pt, x, y))
        b6_ms, b6_share = kernel_share(by_name, card_ms, "gather_bwd_kernel")
        if counts.get("spikemm_gather_bwd"):
            log(f"path [{tag}] {kind}: B6 (gather_bwd_kernel) "
                + ("not in the trace" if b6_ms is None else
                   f"{b6_ms:.4f} ms of the step's {card_ms:.4f} ms of card "
                   f"({b6_share:.1%})"))
        # what the card runs right after each lif_bwd: no PyTorch sum of
        # its partials (the kernel sums g_tau over B itself)
        after = None
        if counts.get("lif_bwd"):
            ran = device_kernels(lambda: step(nt, pt, x, y))
            after = [ran[i + 1] if i + 1 < len(ran) else None
                     for i, k in enumerate(ran) if "lif_bwd_kernel" in k]
            if len(after) != counts["lif_bwd"] // TRAIN_STEPS or any(
                    k is not None and "reduce" in k for k in after):
                raise AssertionError(f"[{tag}] {kind}: the kernels after "
                                     f"lif_bwd in a step: {after}")
            log(f"path [{tag}] {kind}: the kernel after lif_bwd: {after}")
        # the DH-SNN's branch call: one linrec_bwd a step and no PyTorch
        # fill, copy, add or sum of the branches' planes around it; its
        # decay's gradient, summed by the kernel, against the CPU's
        branch_ops = None
        if kind == "dendritic":
            branch_ops = branch_call_ops(lambda: step(nt, pt, x, y), path.T,
                                         path.B, N_BRANCHES, N_HIDDEN)
            log(f"path [{tag}] {kind}: the branch call's PyTorch ops in a "
                "step: " + ("none" if not branch_ops else "; ".join(
                    f"{r['op']} {r['shapes']} x{r['calls']} "
                    f"{r['card_ms']:.4f} ms" for r in branch_ops)))
            if branch_ops:
                raise AssertionError(f"[{tag}] {kind}: PyTorch ops serve "
                                     f"the branch call: {branch_ops}")
            tau_d = leaf_err["hidden/neuron/w_tau_d"]
            if not tau_d <= TAU_D_RTOL:
                raise AssertionError(f"[{tag}] {kind}: w_tau_d card vs CPU "
                                     f"{tau_d:.3e} > {TAU_D_RTOL}")
        log(f"path [{tag}] {kind}: card ms by kernel in a step "
            f"({card_ms if card_ms is None else round(card_ms, 4)} ms in "
            "all): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                 top_per(by_name, 1, n=16).items()))
        rate = fwd["rate"]
        log(f"path [{tag}] {kind}: launches {counts} (+{occ} occupancy; "
            f"recurrent routes {routes}); first step card vs CPU: loss "
            f"{losses[0]:.6f} vs {float(loss_c):.6f} (relative "
            f"{loss_err:.3e}), leaves "
            + ", ".join(f"{k} {v:.3e}" for k, v in leaf_err.items())
            + f"; hidden rate {rate:.4f} ("
            f"{'under' if rate < MIN_HIDDEN_RATE else 'over'} the "
            f"{MIN_HIDDEN_RATE:.0%} floor), {n_ties} lanes flipped at "
            f"threshold ties, {edges} lane-steps within "
            f"{tie.TIE_MARGIN:.0e} of a surrogate window edge; forward "
            f"readout max abs err {err_out:.3e}; never/always bit-equal to "
            f"auto {same}; step {np.median(step_ms):.3f} ms median "
            f"(host clock), card "
            f"{'not measured' if card_ms is None else f'{card_ms:.4f} ms'}")
        models[kind] = {
            "losses": losses, "launches": counts,
            "launches_per_step": {k: v // TRAIN_STEPS
                                  for k, v in counts.items()},
            "occupancy_launches": occ, "rec_routes": routes,
            "loss_cpu": float(loss_c), "loss_rel_err": loss_err,
            "leaf_rel_l2": leaf_err, "hidden_rate": rate,
            "tie_flips": n_ties,
            "rows_diverged": int((first_div < path.T).sum()),
            "window_edges": edges, "readout_max_abs_err": err_out,
            "state_max_abs_err": err_state, "channels": channels,
            "bit_equal_to_auto": same,
            "step_ms_median": float(np.median(step_ms)), "step_ms": step_ms,
            "card_ms": card_ms,
            "card_ms_by_kernel": top_per(by_name, 1, n=12),
            "b6_card_ms": b6_ms, "b6_share": b6_share,
            "after_lif_bwd": after, "branch_call_ops": branch_ops,
            **{k: fwd[k] for k in ("rates",) if k in fwd}}
    return {"path": tag, "model": path.describe, "T": path.T,
            "batch": path.B, "steps": TRAIN_STEPS, "input": path.input,
            "launches": total, "launches_per_run": per_run,
            "models": models, "card": smi}


# ---------------------------------------------------------------------------
# 14. the BCI cross-day decoder: day-0 training and the on-chip fine-tune
# ---------------------------------------------------------------------------


def make_bci(device, grad=False):
    """The default `BCIConfig` (the paper's widths) and its parameters from
    torch.Generator seed BCI_SEED on `device`, every leaf requiring grad
    where `grad`."""
    from repro_torch.core.snn_layers import BCIConfig, bci_init
    cfg = BCIConfig()
    params = bci_init(torch.Generator().manual_seed(BCI_SEED), cfg,
                      device=device)
    for p in params.values():
        p.requires_grad_(grad)
    return cfg, params


def bci_trials(n, day, seed, device, cfg):
    """gen_bci_trials(n, day, seed) at `cfg`'s widths: (n, C, T) signals
    and (n,) labels on `device`."""
    from repro_torch.data.spikes import gen_bci_trials
    x, y = gen_bci_trials(n, day=day, seed=seed, n_channels=cfg.n_channels,
                          n_bins=cfg.n_steps)
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(y).long().to(device))


def bci_step(params, x, y, cfg, keep=False, lr=BCI_LR):
    """One step of `examples/bci_onchip_torch.py`'s day-0 training: the
    cross-entropy of `bci_forward`'s logits, its backward, the clipped SGD
    update at `lr`. Returns (the loss, {leaf: gradient} before the update
    where `keep`, else None)."""
    from repro_torch.core.snn_layers import bci_forward
    logits, _ = bci_forward(params, x, cfg)
    loss = -torch.log_softmax(logits, -1)[
        torch.arange(len(y), device=y.device), y].mean()
    loss.backward()
    return loss.detach(), clipped_sgd(list(params.items()), lr, keep)


def bci_cases():
    """{"lif": [Case], "lif_bwd": [Case]}: the LIF layer's calls of one
    day-0 training step of the bci path on the card, (50, 128, 512) at
    the default `BCIConfig`: the forward captured at `snn_layers.lif_scan`
    (zero reset), the backward at the registry (the `LIF()` surrogate,
    `need_tau=False`, `need_v0=False`: tau and v0 are constants). Timed,
    tagged with the bci path."""
    from repro_torch.core import snn_layers
    cfg, params = make_bci(DEV, grad=True)
    x, y = bci_trials(BCI_TRAIN_B, 0, 0, DEV, cfg)
    fwd, calls = [], {}
    real = snn_layers.lif_scan

    def spy(cur, tau, v0, v_th=1.0, surrogate="rectangle", alpha=1.0,
            reset="zero"):
        fwd.append((cur.detach().clone(), tau.clone(), v0.clone(), v_th,
                    reset))
        return real(cur, tau, v0, v_th, surrogate, alpha, reset)

    snn_layers.lif_scan = spy
    try:
        with recording(bwd_calls=calls):
            bci_step(params, x, y, cfg)
    finally:
        snn_layers.lif_scan = real
    sync()
    (args,), ((bargs, bkw),) = fwd, calls["lif_bwd"]
    want = (cfg.n_steps, BCI_TRAIN_B, cfg.n_paths * cfg.d_path)
    if tuple(args[0].shape) != want or not bool(
            (args[1] == BCI_LIF_TAU).all()) or args[3] != BCI_V_TH \
            or (bkw["need_tau"], bkw["need_v0"]) \
            != (False, False) or (bkw["reset"], bkw["surrogate"],
                                  bkw["alpha"]) != ("zero", BCI_SURROGATE,
                                                    BCI_ALPHA):
        raise AssertionError(f"bci: lif {tuple(args[0].shape)} (want {want}, "
                             f"tau {BCI_LIF_TAU}, v_th {BCI_V_TH}), lif_bwd "
                             f"{bkw}")
    shape = tuple(args[0].shape)
    return {"lif": [Case(f"bci day-0 step {shape}, zero reset", args,
                         path="bci", timed=True)],
            "lif_bwd": [Case(f"bci day-0 step {shape}, {bkw['surrogate']} "
                             f"alpha={bkw['alpha']}, no g_tau, no g_v0",
                             bargs, path="bci", timed=True, kw=bkw)]}


def bci_record_vs_cpu(tag, tie, params_g, params_c, x, cfg):
    """The decoder's forward on the card against the CPU's on the same
    trials `x` (on the card): spikes under the threshold-tie rule (the
    float64 membrane of the CPU's own features), logits within
    BCI_LOGIT_TOL on every trial where no lane flipped. Returns (CPU
    spikes, the CPU's float64 pre-reset membrane, flips, trials with a
    flipped lane, logits error)."""
    from repro_torch.core.snn_layers import bci_features, bci_forward
    xc = x.cpu()
    with torch.no_grad():
        lg, sg = bci_forward(params_g, x, cfg)
        lc, sc = bci_forward(params_c, xc, cfg)
        feat = bci_features(params_c, xc, cfg).numpy()
    s_cpu = sc.numpy()
    u = tie.lif_membrane(feat, BCI_LIF_TAU, s_cpu, BCI_V_TH)
    first_div, flips = tie.tie_rule(s_cpu, sg.cpu().numpy(), u, BCI_V_TH)
    ok = torch.from_numpy(first_div >= cfg.n_steps)
    err = (lg.cpu() - lc).abs()[ok]
    err = float(err.max()) if err.numel() else 0.0
    if not err <= BCI_LOGIT_TOL:
        raise AssertionError(f"[{tag}] logits card vs CPU {err:.3e} > "
                             f"{BCI_LOGIT_TOL} on trials with no flipped lane")
    return s_cpu, u, flips, int((~ok).sum()), err


def phase_bci(smi):
    """The BCI decoder at the paper's widths: TRAIN_STEPS clipped-SGD
    steps on 128 day-0 trials, then on each of days 1-3 the accuracy on
    64 test trials before and after the 32-sample, BCI_FT_STEPS-step
    fine-tune of the readout, all on the card; the launch counters, the
    card against the CPU, the host and card time of a step, the firing
    rate and the simulated TaiBai power of the spike record."""
    from repro_torch.core.simulator import simulate, spike_stats_from_records
    from repro_torch.core.snn_layers import bci_finetune_fc, bci_forward
    from repro_torch.kernels import registry
    tie = load_tie_rule()
    tag = "bci"
    cfg, params = make_bci(DEV, grad=True)
    x0, y0 = bci_trials(BCI_TRAIN_B, 0, 0, DEV, cfg)

    def accuracy(p, x, y):
        with torch.no_grad():
            logits, spikes = bci_forward(p, x, cfg)
        return float((logits.argmax(-1) == y).float().mean()), spikes

    sync()
    registry.reset_launches()
    steps = [bci_step(params, x0, y0, cfg, keep=i == 0)
             for i in range(TRAIN_STEPS)]
    sync()
    train_counts = registry.launch_counts()
    days, records = {}, []
    for day in BCI_DAYS:
        xt, yt = bci_trials(BCI_TEST_B, day, day, DEV, cfg)
        xf, yf = bci_trials(BCI_FEW_B, day, 100 + day, DEV, cfg)
        before, _ = accuracy(params, xt, yt)
        t0 = time.perf_counter()
        tuned, ft_losses = bci_finetune_fc(params, xf, yf, cfg,
                                           lr=BCI_FT_LR, steps=BCI_FT_STEPS)
        sync()
        ft_ms = (time.perf_counter() - t0) * 1e3
        after, spikes = accuracy(tuned, xt, yt)
        records.append(spikes)
        days[day] = {"before": before, "after": after,
                     "finetune_losses": [float(v) for v in ft_losses],
                     "finetune_ms": ft_ms, "trials": (xf, yf),
                     "tuned": tuned}
    sync()
    counts = registry.launch_counts()
    # lif once a forward, lif_bwd once a training step; the fine-tune's
    # features need no gradient, so it launches no lif_bwd
    counted(f"{tag} day-0 training", {"lif": 1, "lif_bwd": 1}, TRAIN_STEPS,
            train_counts)
    forwards = len(BCI_DAYS) * (BCI_FT_STEPS + 2)
    tuning = {k: counts[k] - train_counts[k] for k in counts}
    counted(f"{tag} fine-tune and accuracies", {"lif": 1}, forwards, tuning)
    losses = [float(loss) for loss, _ in steps]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[{tag}] a training loss is not finite: "
                             f"{losses}")
    # the first training step against the CPU's, from the same weights
    _, params_c = make_bci("cpu", grad=True)
    loss_c, grads_c = bci_step(params_c, x0.cpu(), y0.cpu(), cfg, keep=True)
    loss_err = abs(losses[0] - float(loss_c)) / abs(float(loss_c))
    leaf_err = {k: rel_l2(steps[0][1][k].cpu(), v)
                for k, v in grads_c.items()}
    if not loss_err <= TRAIN_LOSS_RTOL or not max(
            leaf_err.values()) <= TRAIN_LEAF_RTOL:
        raise AssertionError(
            f"[{tag}] first step card vs CPU: loss relative {loss_err:.3e} "
            f"(tol {TRAIN_LOSS_RTOL}), leaves {leaf_err} (tol "
            f"{TRAIN_LEAF_RTOL})")
    # the day-0 record of the first step's weights under the tie rule,
    # the logits, the firing floor
    _, p0 = make_bci(DEV)
    _, p0c = make_bci("cpu")
    s_cpu, u, flips, flipped, logit_err = bci_record_vs_cpu(
        f"{tag} day 0", tie, p0, p0c, x0, cfg)
    rate = float(s_cpu.mean())
    if not rate >= MIN_HIDDEN_RATE:
        raise AssertionError(f"[{tag}] the LIF layer fires in {rate:.4%} of "
                             f"its lane-steps, under {MIN_HIDDEN_RATE:.0%}")
    edges = int(tie.surrogate_edges(u, BCI_V_TH, BCI_SURROGATE,
                                    BCI_ALPHA).sum())
    # one day's fine-tune against the CPU's from the same trained weights:
    # the first day whose few-shot record has no lane flipped at a tie (a
    # flipped lane moves that trial's accumulated spikes, and every later
    # step of the fine-tune with them)
    trained_c = {k: v.detach().cpu() for k, v in params.items()}
    trained_g = {k: v.detach() for k, v in params.items()}
    ft_flips, gated = {}, None
    for day, d in days.items():
        xf, yf = d["trials"]
        ft_flips[day] = bci_record_vs_cpu(f"{tag} day {day} few-shot", tie,
                                          trained_g, trained_c, xf, cfg)[2]
        if gated is None and ft_flips[day] == 0:
            gated = day
    if gated is None:
        raise AssertionError(f"[{tag}] every fine-tune day's record has a "
                             f"lane flipped at a tie: {ft_flips}")
    xf, yf = days[gated]["trials"]
    tuned_c, ft_losses_c = bci_finetune_fc(trained_c, xf.cpu(), yf.cpu(), cfg,
                                           lr=BCI_FT_LR, steps=BCI_FT_STEPS)
    ft_err = {"losses": rel_l2(torch.tensor(days[gated]["finetune_losses"]),
                               ft_losses_c)}
    ft_err.update({k: rel_l2(days[gated]["tuned"][k].detach().cpu(),
                             tuned_c[k]) for k in ("fc_w", "fc_b")})
    if not max(ft_err.values()) <= BCI_FT_RTOL:
        raise AssertionError(f"[{tag}] day {gated}'s fine-tune card vs CPU: "
                             f"{ft_err} (relative L2, tol {BCI_FT_RTOL})")
    # the step's time (host clock, median) and the card's by kernel
    _, pt = make_bci(DEV, grad=True)
    for _ in range(TRAIN_WARMUP):
        bci_step(pt, x0, y0, cfg)
    sync()
    step_ms = []
    for _ in range(TRAIN_TIMED):
        t0 = time.perf_counter()
        bci_step(pt, x0, y0, cfg)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    card_ms, by_name = profile_ms(lambda: bci_step(pt, x0, y0, cfg))
    # the simulated TaiBai power of the fine-tuned decoder's spike record
    # on the three days' test trials, in bench_applications.bci_task's
    # layer statistics (fan-out the channels, dense FLOPs a step
    # 2 x features x channels x bins), over its 100 timesteps
    n_feat = cfg.n_paths * cfg.d_path
    stats = spike_stats_from_records(
        {"paths": torch.cat(records, dim=1)}, {"paths": cfg.n_channels},
        {"paths": 2.0 * n_feat * cfg.n_channels * cfg.n_steps})
    stats = [dataclasses.replace(s, spike_rate=max(s.spike_rate, 1e-3))
             for s in stats]
    sim = simulate(stats, timesteps=100).asdict()
    step_med = float(np.median(step_ms))
    log(f"path [{tag}] losses {losses}; launches {counts}; first step card "
        f"vs CPU: loss {losses[0]:.6f} vs {float(loss_c):.6f} (relative "
        f"{loss_err:.3e}), leaves "
        + ", ".join(f"{k} {v:.3e}" for k, v in leaf_err.items())
        + f"; day-0 record: rate {rate:.4f}, {flips} lanes flipped at "
        f"threshold ties ({flipped} trials), {edges} lane-steps within "
        f"{tie.TIE_MARGIN:.0e} of the surrogate window's edge, logits max "
        f"abs err {logit_err:.3e}; few-shot flips by day {ft_flips}, day "
        f"{gated}'s fine-tune card vs CPU {ft_err}; accuracy before/after "
        + ", ".join(f"day {k} {v['before']:.3f}/{v['after']:.3f}"
                    for k, v in days.items())
        + f"; step {step_med:.3f} ms median (host clock), card "
        f"{'not measured' if card_ms is None else f'{card_ms:.4f} ms'}; "
        f"simulated TaiBai {sim['power_w']:.4f} W, efficiency "
        f"{sim['efficiency_x']:.1f}x the modelled RTX 3090")
    return {"path": tag, "model": f"BCIConfig() {cfg.n_channels} channels x "
            f"{cfg.n_steps} bins, {cfg.n_paths} paths x {cfg.d_path}, "
            f"kernel_t {cfg.kernel_t}, {cfg.n_out} classes; clipped SGD lr "
            f"{BCI_LR}, fine-tune lr {BCI_FT_LR} x {BCI_FT_STEPS} steps",
            "input": f"gen_bci_trials({BCI_TRAIN_B}, day=0); days "
            f"{list(BCI_DAYS)}: {BCI_TEST_B} test, {BCI_FEW_B} few-shot",
            "T": cfg.n_steps, "batch": BCI_TRAIN_B, "steps": TRAIN_STEPS,
            "launches": counts, "launches_per_run": {
                k: int(k in ("lif", "lif_bwd")) for k in counts},
            "launches_training": train_counts, "losses": losses,
            "loss_cpu": float(loss_c), "loss_rel_err": loss_err,
            "leaf_rel_l2": leaf_err, "hidden_rate": rate,
            "tie_flips": flips, "trials_flipped": flipped,
            "window_edges": edges, "logits_max_abs_err": logit_err,
            "finetune_flips": ft_flips, "finetune_day_gated": gated,
            "finetune_rel_l2": ft_err,
            "days": {k: {kk: v[kk] for kk in ("before", "after",
                                               "finetune_losses",
                                               "finetune_ms")}
                     for k, v in days.items()},
            "step_ms_median": step_med, "step_ms": step_ms,
            "card_ms": card_ms,
            "busy_share": None if card_ms is None else card_ms / step_med,
            "card_ms_by_kernel": top_per(by_name, 1, n=12),
            "simulated": sim, "card": smi}


# ---------------------------------------------------------------------------
# 15. attention and 16. parity
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnCase:
    """One call of `flash_attention`: q (BH, T, d), k and v (BH, S, d);
    `kv_heads` draws k and v with that many heads and repeats each to
    BH / kv_heads q heads (GQA)."""
    label: str
    BH: int
    T: int
    S: int
    d: int
    causal: bool = True
    window: int = 0
    dtype: torch.dtype = torch.float32
    kv_heads: int = None
    timed: bool = False


def attention_cases():
    """The JAX kernel tests' grid (BH=4; non-causal only at T = S) and their
    bf16 case; `_make_inputs`' shape; every head-dim template of the kernel
    and ragged d; rows with no allowed key; the padded-key shape;
    `bench_kernels`' shape; and at full width the kernel's inputs for one
    prompt of the prefill_32k shape (T = 32768, models/config.py): qwen2-1.5b
    (12 heads, 2 KV heads, d = 128) and zamba2-1.2b's shared block (32
    heads, d = 64) with the long-context window of configs/__init__.py:56,
    in the configs' bf16; and K/V past element 2^31."""
    bf16 = torch.bfloat16
    grid = [AttnCase(f"grid T={T} S={S} d={d} causal={c} window={w}", 4, T,
                     S, d, c, w)
            for T, S, d in ((256, 256, 64), (512, 512, 128), (384, 640, 64))
            for c, w in ((True, 0), (True, 128), (False, 0)) if c or T == S]
    return grid + [
        AttnCase("bf16", 2, 256, 256, 64, dtype=bf16),
        AttnCase("make_inputs", 2, 160, 160, 64, timed=True),
        AttnCase("d=16", 2, 160, 160, 16),
        AttnCase("d=96 window", 3, 200, 330, 96, window=64),
        AttnCase("d=32 non-causal window", 2, 100, 77, 32, causal=False,
                 window=20),
        AttnCase("d=256 non-causal", 2, 130, 130, 256, causal=False),
        AttnCase("d=1", 1, 70, 70, 1),
        AttnCase("no allowed key", 2, 256, 64, 64, window=32),
        AttnCase("padded keys", 2, 256, 160, 64),
        AttnCase("bench", 4, 1024, 1024, 64, timed=True),
        AttnCase("qwen2_32k", 12, 32768, 32768, 128, dtype=bf16, kv_heads=2,
                 timed=True),
        AttnCase("zamba2_w4096", 32, 32768, 32768, 64, window=4096,
                 dtype=bf16, timed=True),
        AttnCase("int64", 17, 128, 1 << 20, 128, causal=False, dtype=bf16,
                 timed=True),
    ] + [
        # the ragged and edge shapes above in bf16 at the tensor-core
        # route's widths, so that route and its split meet their edges
        AttnCase(f"bf16 {label} d={d}", BH, T, S, d, causal, window,
                 dtype=bf16)
        for d in TC_HEAD_DIMS
        for label, BH, T, S, causal, window in (
            ("T != S", 4, 384, 640, True, 0),
            ("T != S window", 4, 384, 640, True, 128),
            ("non-causal", 4, 512, 512, False, 0),
            ("non-causal window", 2, 100, 77, False, 20),
            ("no allowed key", 2, 256, 64, True, 32),
            ("padded keys", 2, 256, 160, True, 0),
            ("T not a multiple of 128", 3, 200, 330, True, 64))
    ] + [AttnCase("bf16 split d=64", 4, 256, 4096, 64, causal=False,
                  dtype=bf16)]


def attention_inputs(c, seed):
    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((c.BH, c.T, c.d), generator=g, device=DEV, dtype=c.dtype)
    kv = []
    for _ in range(2):
        x = torch.randn((c.kv_heads or c.BH, c.S, c.d), generator=g,
                        device=DEV, dtype=c.dtype)
        kv.append(x.repeat_interleave(c.BH // c.kv_heads, dim=0)
                  if c.kv_heads else x)
    return q, kv[0], kv[1]


def attention_plain(c, q, k, v):
    """The plain version on the card, a few heads a call where the whole
    (BH, T, S) fp32 score plane would pass ATTN_PLAIN_BYTES."""
    from repro_torch.kernels.attention.ref import attention_ref
    step = max(1, ATTN_PLAIN_BYTES // (4 * c.T * c.S))
    return torch.cat([attention_ref(q[h:h + step], k[h:h + step],
                                    v[h:h + step], causal=c.causal,
                                    window=c.window)
                      for h in range(0, c.BH, step)])


def attention_work(c):
    """(bytes, operations on this run's masks, operations of the dense
    product) of one call: q, k, v read once and o written once; 4 d
    operations (two d-long products) per (q, k) pair the softmax weighs,
    which is every key for a row with no allowed key."""
    t = np.arange(c.T, dtype=np.int64)
    lo = np.maximum(t - c.window + 1, 0) if c.window > 0 else 0 * t
    hi = np.minimum(t, c.S - 1) if c.causal else 0 * t + c.S - 1
    n = np.maximum(hi - lo + 1, 0)
    if c.window > 0:
        n = np.where(t >= c.S + c.window - 1, c.S, n)
    esize = torch.finfo(c.dtype).bits // 8
    nbytes = esize * c.BH * 2 * (c.T + c.S) * c.d
    return (nbytes, 4 * c.d * c.BH * int(n.sum()),
            4 * c.d * c.BH * c.T * c.S)


def attention_bound(c, nbytes, ops):
    """max(bytes / HBM rate, operations / the peak for the input type: the
    bf16 tensor cores for bf16, the fp32 CUDA cores for fp32)."""
    peak = PEAK_BF16_FLOPS if c.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_call(c, q, k, v):
    """`scaled_dot_product_attention` on the same tensors in (BH, 1, T, d)
    form, restricted to its fused backends: a yardstick only, the port
    never calls it. Causal alone is `is_causal` (aligned at (0, 0), as the
    kernel's positions are); a window is a boolean mask."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    fused = [getattr(SDPBackend, b) for b in (
        "FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")
        if hasattr(SDPBackend, b)]
    mask = None
    if c.window > 0:
        dpos = (torch.arange(c.T, device=DEV)[:, None]
                - torch.arange(c.S, device=DEV)[None, :])
        mask = dpos < c.window
        if c.causal:
            mask &= dpos >= 0
    qs, ks, vs = (x.unsqueeze(1) for x in (q, k, v))

    def call():
        with sdpa_kernel(fused):
            return F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask,
                is_causal=c.causal and mask is None)
    return call


def attention_check(c, got, ref):
    """Hold one output to the plain version's (see ATTN_TOL and its
    neighbours): elementwise, then head by head in relative norm, and no
    head all zero. Returns (max abs err, the worst head's relative norm,
    the tolerance as text)."""
    got, ref = got.float(), ref.float()
    if c.dtype == torch.float32:
        rtol = atol = ATTN_TOL
    else:
        rtol = ATTN_BF16_RTOL
        atol = ATTN_BF16_ATOL_RMS * float(ref.square().mean().sqrt())
    try:
        torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)
    except AssertionError as e:
        raise AssertionError(f"attention [{c.label}]: {e}") from None
    dead = (got.flatten(1).abs().amax(dim=1) == 0).nonzero().flatten()
    if dead.numel():
        raise AssertionError(f"attention [{c.label}]: heads "
                             f"{dead.tolist()[:8]} are all zero")
    rel = ((got - ref).flatten(1).norm(dim=1)
           / ref.flatten(1).norm(dim=1)).max()
    if not float(rel) <= ATTN_HEAD_REL:
        raise AssertionError(f"attention [{c.label}]: a head's relative "
                             f"norm error {float(rel):.3e} > {ATTN_HEAD_REL}")
    return (float((got - ref).abs().max()), float(rel),
            f"rtol {rtol:.3g}, atol {atol:.3g}")


def phase_attention(smi):
    """`flash_attention` through the registry at every case, counted; each
    output against the plain version on the card; times; the
    straight-through VJP."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.attention import ops
    from repro_torch.kernels.attention.ops import (flash_attention,
                                                   flash_attention_cuda)
    from repro_torch.kernels.attention.ref import attention_ref
    tag = "attention"
    cases = attention_cases()
    inputs = [attention_inputs(c, seed) for seed, c in enumerate(cases)]
    sms = ops.sm_count(torch.device(DEV))
    plans = [ops.plan_call(c.BH, c.T, c.S, c.d, c.dtype, sms) for c in cases]
    sync()
    registry.reset_launches()
    t0 = time.perf_counter()
    outs, routes = [], []
    for c, (q, k, v) in zip(cases, inputs):
        before = ops.route_launch_counts()
        outs.append(flash_attention(q, k, v, causal=c.causal,
                                    window=c.window))
        after = ops.route_launch_counts()
        routes.append({r: after[r] - before[r] for r in after
                       if after[r] != before[r]})
    sync()
    wall = (time.perf_counter() - t0) * 1e3
    counts = registry.launch_counts()
    # each case launches its planned route's kernels, one count a launch:
    # the tensor-core kernel and, for a split, the combine; or the
    # CUDA-core kernel
    for c, plan, got in zip(cases, plans, routes):
        want = ({ops.TENSOR_CORES: 1, **({ops.COMBINE: 1} if plan.nsplit > 1
                                         else {})}
                if plan.route == ops.TENSOR_CORES else {ops.CUDA_CORES: 1})
        if got != want:
            raise AssertionError(f"[{tag}] {c.label}: launches {got}, the "
                                 f"plan {plan} launches {want}")
        if (c.dtype == torch.bfloat16 and c.d in TC_HEAD_DIMS) != (
                plan.route == ops.TENSOR_CORES):
            raise AssertionError(f"[{tag}] {c.label}: route {plan.route} "
                                 f"for {c.dtype} d={c.d}")
    if plans[[c.label for c in cases].index("int64")].nsplit < 2:
        raise AssertionError(f"[{tag}] int64 ran without a split")
    per_run = sum(sum(r.values()) for r in routes)
    counted(tag, {"attention": per_run}, 1, counts)
    by_route = {r: sum(x.get(r, 0) for x in routes)
                for r in (ops.TENSOR_CORES, ops.COMBINE, ops.CUDA_CORES)}

    calls, max_err, max_err_f32, max_rel = [], 0.0, 0.0, 0.0
    for c, (q, k, v), got, plan in zip(cases, inputs, outs, plans):
        if got.dtype != c.dtype or tuple(got.shape) != (c.BH, c.T, c.d):
            raise AssertionError(f"attention [{c.label}]: {got.dtype} "
                                 f"{tuple(got.shape)}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"attention [{c.label}]: non-finite")
        err, rel, tol = attention_check(c, got, attention_plain(c, q, k, v))
        max_err, max_rel = max(max_err, err), max(max_rel, rel)
        if c.dtype == torch.float32:
            max_err_f32 = max(max_err_f32, err)
        shape = (f"q {(c.BH, c.T, c.d)}, k/v {(c.BH, c.S, c.d)} "
                 f"{str(c.dtype)[6:]}, causal={c.causal}, window={c.window}, "
                 f"{plan.route}"
                 + (f", {plan.nsplit} splits" if plan.nsplit > 1 else ""))
        if not c.timed:
            log(f"kernel attention [{c.label}] {shape}: within {tol} of "
                f"plain, max abs err {err:.3e}, head rel norm {rel:.3e}")
            continue
        big = c.T * c.S * c.BH > 2 ** 28
        ms = cuda_ms(lambda: flash_attention_cuda(
            q, k, v, causal=c.causal, window=c.window),
            iters=3 if big else 50, warmup=1 if big else 3)
        p_ms = cuda_ms(lambda: attention_plain(c, q, k, v),
                       iters=1 if big else 10, warmup=1 if big else 3)
        try:
            lib = cuda_ms(sdpa_call(c, q, k, v), iters=3 if big else 50,
                          warmup=1 if big else 3)
        except RuntimeError as e:        # no fused SDPA backend takes it
            log(f"kernel attention [{c.label}]: no library time ({e})")
            lib = None
        nbytes, ops, dense = attention_work(c)
        b_ms, b_by = attention_bound(c, nbytes, ops)
        d_ms, d_by = attention_bound(c, nbytes, dense)
        calls.append({"call": c.label, "path": tag, "shape": shape,
                      "route": plan.route, "nsplit": plan.nsplit,
                      "launches": 1 + int(plan.nsplit > 1),
                      "ms": ms, "plain_ms": p_ms, "library_ms": lib,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "bound_dense_ms": d_ms, "bound_dense_by": d_by,
                      "bytes": nbytes, "flops": ops, "dense_flops": dense,
                      "max_abs_err": err, "head_rel_err": rel})
        log(f"kernel attention [{c.label}] {shape}: {ms:.4f} ms on the card "
            f"(plain {p_ms:.4f}, library "
            f"{lib if lib is None else round(lib, 4)}, bound {b_ms:.5f} by "
            f"{b_by}, dense bound {d_ms:.5f} by {d_by}; "
            f"{'' if lib is None else f'{ms / lib:.2f}x SDPA, '}"
            f"{ms / b_ms:.1f}x the bound); within {tol} of plain, max abs "
            f"err {err:.3e}, head rel norm {rel:.3e}")
    del inputs, outs

    # the straight-through VJP where the parity phase does not reach it
    # (that holds _make_inputs' (2, 160, 64) causal): T != S and a window
    g = torch.Generator(device=DEV).manual_seed(len(cases))
    qkv = [torch.randn((2, n, 64), generator=g, device=DEV)
           for n in (256, 160, 160)]
    grads = []
    for fn in (flash_attention, attention_ref):
        args = [x.clone().requires_grad_() for x in qkv]
        loss = torch.sin(fn(*args, causal=True, window=128) * 0.7).sum()
        grads.append(torch.autograd.grad(loss, args))
    vjp_err = max(float((a - b).abs().max()) for a, b in zip(*grads))
    if not vjp_err <= ATTN_VJP_TOL:
        raise AssertionError(f"[{tag}] straight-through VJP max abs err "
                             f"{vjp_err:.3e} > {ATTN_VJP_TOL}")
    log(f"path [{tag}]: launches {counts} over {len(cases)} calls "
        f"({by_route}, each case's as its plan) in "
        f"{wall:.1f} ms; every case within tolerance (max abs err "
        f"{max_err:.3e}, fp32 {max_err_f32:.3e}, worst head rel norm "
        f"{max_rel:.3e}); straight-through VJP (T=256, S=160, window 128) "
        f"max abs err {vjp_err:.3e}")
    src, rep = SOURCES["attention"]
    home = next(x for x in calls if x["call"] == ATTN_HOME)
    kernel = {"name": "attention", "route": "cuda", "source": src,
              "replaces": rep, "launches": None, "max_abs_err": max_err,
              "max_abs_err_fp32": max_err_f32, "path": tag,
              "call": ATTN_HOME, "ms": home["ms"],
              "plain_ms": home["plain_ms"], "bound_ms": home["bound_ms"],
              "bound_by": home["bound_by"],
              "bound_dense_ms": home["bound_dense_ms"],
              "library_ms": home["library_ms"], "calls": calls}
    sl = {"path": tag, "model": "flash_attention", "cases": len(cases),
          "launches": counts, "launches_per_run": {"attention": per_run},
          "launches_by_route": by_route,
          "first_run_ms": wall, "max_abs_err": max_err,
          "max_abs_err_fp32": max_err_f32, "head_rel_err": max_rel,
          "vjp_max_abs_err": vjp_err,
          "card": smi}
    return kernel, sl


# ---------------------------------------------------------------------------
# 16. verifier
# ---------------------------------------------------------------------------

VERIFIER_TIMED = 2            # replays timed a setting, alternating
VERIFIER_COMPILES = 5         # compile_program calls timed a program
TB305_RATIO = 8               # the model within this factor of the launch
VERIFIER_DENSITIES = (0.01, 0.05, 0.5)
VERIFIER_TRACE = ROOT / "build" / "verifier_trace.json"


@contextlib.contextmanager
def check_mode(mode):
    """REPRO_CHECK set to `mode` for the block, restored after."""
    prev = os.environ.get("REPRO_CHECK")
    os.environ["REPRO_CHECK"] = mode
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("REPRO_CHECK", None)
        else:
            os.environ["REPRO_CHECK"] = prev


def verifier_cli():
    """`python -m repro_torch.analysis --all --fail-on warning` in this
    process on the card: no finding at warning or above."""
    import io
    from repro_torch.analysis.__main__ import main
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(["--all", "--fail-on", "warning"])
    wall = time.perf_counter() - t0
    out = buf.getvalue().strip().splitlines()
    m = re.fullmatch(r"-- (\d+) error\(s\), (\d+) warning\(s\), (\d+) info",
                     out[-1] if out else "")
    if rc != 0 or m is None or m.group(1) != "0" or m.group(2) != "0":
        raise AssertionError("verifier: analysis --all --fail-on warning "
                             f"exited {rc}:\n" + "\n".join(out))
    counts = dict(zip(("errors", "warnings", "info"),
                      map(int, m.groups())))
    log(f"verifier [cli]: analysis --all --fail-on warning: {counts}, "
        f"{wall:.3f} s wall")
    return {**counts, "wall_s": wall}


def verifier_programs():
    """{name: nodes} of each path's program, built on the card."""
    progs = {p.name: p.make_model(DEV)[0] for p in PATHS}
    progs["alif_ff"] = make_alif_ff(DEV)[0]
    progs["sparse_integ"] = make_sparse_integ(DEV)[0]
    progs["plastic_ff"] = make_plastic("pair_stdp", DEV)[0]
    return progs


def compile_ms():
    """compile_program's host ms (median of VERIFIER_COMPILES calls) for
    each path's program, under REPRO_CHECK=off and =raise."""
    from repro_torch.core import plan
    out = {}
    for name, nodes in verifier_programs().items():
        row = {}
        for mode in ("off", "raise"):
            with check_mode(mode):
                plan.compile_program(nodes)
                ts = []
                for _ in range(VERIFIER_COMPILES):
                    t0 = time.perf_counter()
                    plan.compile_program(nodes)
                    ts.append((time.perf_counter() - t0) * 1e3)
            row[mode] = float(np.median(ts))
        out[name] = row
        log(f"verifier [compile]: {name}: compile_program {row['off']:.4f} "
            f"ms under off, {row['raise']:.4f} ms under raise (host, "
            f"median of {VERIFIER_COMPILES})")
    return out


def weight_collision(device):
    """The reference test's TB231 program at the SHD widths: two plastic
    edges of one node learning `w_shared`, and its weights on `device`."""
    from repro_torch.core.events import Connection, LayerNode
    from repro_torch.core.neuron import LIF
    from repro_torch.core.plasticity import pair_stdp
    from repro_torch.core.snn_layers import ff_integrate
    rule = pair_stdp()
    pre = LayerNode("pre", LIF(), ff_integrate, inputs=(Connection("input"),),
                    out_dim=N_HIDDEN)
    h = LayerNode("h", LIF(), ff_integrate, out_dim=N_HIDDEN, inputs=(
        Connection("input", plastic=rule, weight="w_shared"),
        Connection("pre", plastic=rule, weight="w_shared")))
    g = torch.Generator().manual_seed(0)
    params = {"pre": {"w_input": torch.randn((N_IN, N_HIDDEN), generator=g)},
              "h": {"w_shared": torch.randn((N_IN, N_HIDDEN), generator=g)}}
    return [pre, h], {k: {kk: v.to(device) for kk, v in d.items()}
                      for k, d in params.items()}


def verifier_served():
    """The served SHD DH-SNN under REPRO_CHECK=raise against =off."""
    from repro_torch.analysis import DiagnosticError
    from repro_torch.kernels import registry
    from repro_torch.serve import EngineConfig, make_engine
    path = PATHS[0]
    nodes, params = make_shd(True, DEV)
    streams = shd_streams(CAPACITY)
    trace = make_trace(streams)
    cfg = EngineConfig(window=WINDOW, capacity=CAPACITY, queue_limit=None)
    # each setting twice, alternating, the second kept: a setting's first
    # run may pay the allocator's first device allocations (host syncs)
    runs, first = {}, {}
    for mode in ("off", "raise", "off", "raise"):
        with check_mode(mode):
            eng = make_engine(nodes, params, cfg, device=DEV)
            sync()
            registry.reset_launches()
            _, syncs = sync_warnings(lambda: replay(eng, trace))
            counts = registry.launch_counts()
            ops = host_ops(lambda: replay(make_engine(nodes, params, cfg,
                                                      device=DEV), trace))
            first.setdefault(mode, syncs)
            runs[mode] = dict(eng=eng, syncs=syncs, counts=counts, ops=ops)
            counted(f"verifier {mode}", path.per_window,
                    eng.metrics.windows_run, counts)
    log(f"verifier [served]: host syncs over a run, first and second run "
        f"of each setting: off {first['off']}, {runs['off']['syncs']}; "
        f"raise {first['raise']}, {runs['raise']['syncs']}")
    off, rai = runs["off"], runs["raise"]
    wins = off["eng"].metrics.windows_run
    if rai["eng"].metrics.windows_run != wins or rai["counts"] != \
            off["counts"]:
        raise AssertionError(f"verifier: raise ran {rai['counts']} over "
                             f"{rai['eng'].metrics.windows_run} windows, off "
                             f"{off['counts']} over {wins}")
    for sid in streams:
        a, b = off["eng"].outputs(sid), rai["eng"].outputs(sid)
        if a.shape != b.shape or not np.array_equal(a.view(np.int32),
                                                    b.view(np.int32)):
            raise AssertionError(f"verifier: {sid}'s outputs under raise "
                                 "differ from off")
    if rai["ops"] != off["ops"] or rai["syncs"] != off["syncs"]:
        raise AssertionError(
            f"verifier: raise ran {len(rai['ops'])} ops and {rai['syncs']} "
            f"host syncs, off {len(off['ops'])} and {off['syncs']}")
    lat = {"off": [], "raise": []}
    for _ in range(VERIFIER_TIMED):
        for mode in lat:
            with check_mode(mode):
                replay(make_engine(nodes, params, cfg, device=DEV), trace,
                       lat[mode])
    p50 = {m: float(np.percentile(v, 50)) * 1e3 for m, v in lat.items()}
    # the TB231 collision raises at compile time, before any launch
    cn, cp = weight_collision(DEV)
    registry.reset_launches()
    with check_mode("raise"):
        try:
            make_engine(cn, cp, cfg, device=DEV)
        except DiagnosticError as e:
            codes = sorted({d.code for d in e.diagnostics})
        else:
            raise AssertionError("verifier: the TB231 collision compiled "
                                 "under REPRO_CHECK=raise")
    sync()
    if "TB231" not in codes or any(registry.launch_counts().values()):
        raise AssertionError(f"verifier: the collision raised {codes} with "
                             f"launches {registry.launch_counts()}")
    log(f"verifier [served]: {wins} windows under off and raise: outputs "
        f"bit for bit, launches a window {path.per_window}, "
        f"{len(off['ops'])} PyTorch ops and {off['syncs']} host syncs over "
        f"the run under both; p50 window {p50['off']:.3f} ms under off, "
        f"{p50['raise']:.3f} under raise (host, {len(lat['off'])} samples "
        f"each); the TB231 collision raised DiagnosticError {codes} with no "
        "launch")
    return {"windows": wins, "launches": rai["counts"],
            "launches_per_window": {k: v // wins
                                    for k, v in rai["counts"].items()},
            "ops": len(off["ops"]), "syncs": off["syncs"],
            "p50_window_ms": p50, "window_samples": len(lat["off"]),
            "collision_codes": codes}


# -- (c) tile models against the card's launches -----------------------------


def graph_launches(fn):
    """The kernel launches of one call of `fn` (`graph_nodes`): [(mangled
    name, grid, block, dynamic shared memory, static shared memory)]."""
    return [(name, (p.gx, p.gy, p.gz), (p.bx, p.by, p.bz), int(p.smem),
             int(static)) for name, p, static in graph_nodes(fn)
            if p is not None]


def trace_launches(fn, traces=3):
    """The kernel events of one call of `fn` in torch.profiler's exported
    Kineto trace: [(name, args)], in launch order; empty when no trace
    held a kernel event."""
    from torch.profiler import ProfilerActivity, profile
    VERIFIER_TRACE.parent.mkdir(parents=True, exist_ok=True)
    for _ in range(traces):
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        prof.export_chrome_trace(str(VERIFIER_TRACE))
        evs = json.loads(VERIFIER_TRACE.read_text()).get("traceEvents", [])
        kern = sorted((e for e in evs if e.get("cat") == "kernel"),
                      key=lambda e: e.get("ts", 0))
        if kern:
            return [(e["name"], e.get("args", {})) for e in kern]
        torch.cuda.empty_cache()
    return []


def _mangled(kernel, name):
    """Whether mangled `name` is kernel function `kernel` (its
    length-prefixed identifier)."""
    return f"{len(kernel)}{kernel}" in name


def _demangled(kernel, name):
    return re.search(rf"(?<![\w]){re.escape(kernel)}(?=[<(])", name) \
        is not None


def _trace_smem(args):
    """The shared memory a trace event reports, or None."""
    for key in ("shared memory", "shared_memory", "sharedMemory"):
        if key in args:
            return int(args[key])
    return None


def verifier_inputs(name, dims, blocks):
    """A call of family `name`'s route at `dims` (and a route `blocks`
    pins) on the card, inputs from seed 0: the counted wrapper, or for a
    pinned route the launch function its wrapper calls."""
    from repro_torch.kernels.alifrec.ops import alif_cuda, alifrec_cuda
    from repro_torch.kernels.attention.ops import flash_attention_cuda
    from repro_torch.kernels.common import plan_sms
    from repro_torch.kernels.lif.ops import lif_cuda
    from repro_torch.kernels.lifrec.ops import lifrec_cuda
    from repro_torch.kernels.linrec.ops import linrec_cuda
    from repro_torch.kernels.spikemm import gather, sparse
    from repro_torch.kernels.spikemm.ops import (spikemm_cuda,
                                                 spikemm_sessions_cuda)
    from repro_torch.kernels.stdp.ops import (stdp_seq_cuda,
                                              stdp_seq_sessions_cuda,
                                              stdp_update_cuda)
    g = torch.Generator().manual_seed(0)

    def rand(*shape, p=None):
        x = torch.rand(shape, generator=g)
        return (x < p).float().to(DEV) if p is not None else x.to(DEV)
    d = dims
    if name == "spikemm":
        s, w = rand(d["M"], d["K"], p=0.2), rand(d["K"], d["N"])
        if "st" not in blocks:
            return lambda: spikemm_cuda(s, w)

        def sparse_route():
            flags, _ = sparse.occupancy_cuda(s)
            out = torch.empty((d["M"], d["N"]), device=DEV)
            sparse.launch_product(s, w, flags, out, blocks["st"])
        return sparse_route
    if name == "spikemm_sessions":
        s, w = rand(d["T"], d["S"], d["K"], p=0.2), rand(d["S"], d["K"],
                                                         d["N"])
        return lambda: spikemm_sessions_cuda(s, w)
    if name == "spikemm_gather":
        rng = np.random.default_rng(0)
        mask = rng.random((d["K"], d["N"])) < 0.05
        pre, post = np.nonzero(mask)
        tables = gather.build_gather_tables(
            pre, post, rng.standard_normal(len(pre)).astype(np.float32),
            d["K"], d["N"], bk=d["BK"], bn=d["BN"])
        s = rand(d["M"], d["K"], p=0.3)
        plan = gather.gather_plan(d["M"], d["BN"], d["JB"], plan_sms(),
                                  cols=blocks["cols"])

        def gather_route():
            out = torch.empty((d["M"], d["N"]), device=DEV)
            gather.launch_plan(s, tables, out, plan)
        return gather_route
    if name in ("linrec", "lif", "alif"):
        T, B, N = d["T"], d["B"], d["N"]
        cur = rand(T, B, N) - 0.3
        tau = 0.7 + 0.28 * rand(N)
        zero = torch.zeros((B, N), device=DEV)
        if name == "linrec":
            a = 0.5 + 0.49 * (rand(T, B, N) if d["P"] == 2 else rand(N))
            return lambda: linrec_cuda(a, cur, zero)
        if name == "lif":
            return lambda: lif_cuda(cur, tau, zero)
        rho = 0.85 + 0.14 * rand(N)
        return lambda: alif_cuda(cur, tau, rho, zero, zero)
    if name in ("lifrec", "alifrec"):
        T, B, N = d["T"], d["B"], d["N"]
        cur = rand(T, B, N) - 0.3
        w = (0.4 / N ** 0.5) * (rand(N, N) - 0.5)
        tau = 0.7 + 0.28 * rand(N)
        zero = torch.zeros((B, N), device=DEV)
        if name == "lifrec":
            return lambda: lifrec_cuda(cur, w, tau, zero, zero)
        rho = 0.85 + 0.14 * rand(N)
        return lambda: alifrec_cuda(cur, w, tau, rho, zero, zero, zero)
    if name == "stdp":
        B, M, N = d["B"], d["M"], d["N"]
        args = (rand(B, M), rand(B, N, p=0.2), rand(B, M, p=0.2), rand(B, N),
                rand(M, N))
        return lambda: stdp_update_cuda(*args)
    if name == "stdp_seq":
        K, rows = d["K"], d["T"] * d["B"]
        P, Q, w = rand(K, rows, d["M"]), rand(K, rows, d["N"], p=0.2), \
            rand(d["M"], d["N"])
        return lambda: stdp_seq_cuda(P, Q, w, amps=(0.01,) * K, w_min=-1.0,
                                     w_max=1.0, batch=d["B"])
    if name == "stdp_seq_sessions":
        K, rows = d["K"], d["T"] * d["S"]
        P, Q = rand(K, rows, d["M"]), rand(K, rows, d["N"], p=0.2)
        w = rand(d["S"], d["M"], d["N"])
        return lambda: stdp_seq_sessions_cuda(P, Q, w, amps=(0.01,) * K,
                                              w_min=-1.0, w_max=1.0)
    if name == "attention":
        dt = torch.bfloat16 if d["bf16"] else torch.float32
        q = rand(d["BH"], d["T"], d["d"]).to(dt)
        k, v = (rand(d["BH"], d["S"], d["d"]).to(dt) for _ in range(2))
        return lambda: flash_attention_cuda(q, k, v, causal=True)
    raise AssertionError(f"verifier: no inputs for family {name!r}")


def verifier_bwd_inputs(name, dims):
    """A call of the backward kernel `name` (a launch counter's name) at
    its forward's `dims` on the card, inputs from seed 0."""
    from repro_torch.kernels.alifrec.ops import alif_bwd_cuda, \
        alifrec_bwd_cuda
    from repro_torch.kernels.lif.ops import lif_bwd_cuda
    from repro_torch.kernels.lifrec.ops import lifrec_bwd_cuda
    from repro_torch.kernels.linrec.ops import linrec_bwd_cuda
    from repro_torch.kernels.spikemm import gather
    from repro_torch.kernels.spikemm.wgrad import spikemm_wgrad_cuda
    g = torch.Generator().manual_seed(0)

    def rand(*shape, p=None):
        x = torch.rand(shape, generator=g)
        return (x < p).float().to(DEV) if p is not None else x.to(DEV)
    d = dims
    if name == "spikemm_wgrad":
        s, gr = rand(d["R"], d["K"], p=0.2), rand(d["R"], d["N"])
        return lambda: spikemm_wgrad_cuda(s, gr)
    if name == "spikemm_gather_bwd":
        rng = np.random.default_rng(0)
        pre, post = np.nonzero(rng.random((d["K"], d["N"])) < 0.05)
        tables = gather.build_gather_tables(
            pre, post, rng.standard_normal(len(pre)).astype(np.float32),
            d["K"], d["N"], bk=d["BK"], bn=d["BN"])
        gr = rand(d["M"], d["N"])
        return lambda: gather.spikemm_gather_bwd_cuda(gr, tables)
    T, B, N = d["T"], d["B"], d["N"]
    cur, sp, gs = rand(T, B, N) - 0.3, rand(T, B, N, p=0.2), rand(T, B, N)
    tau, rho = 0.7 + 0.28 * rand(N), 0.85 + 0.14 * rand(N)
    lane = [rand(B, N) for _ in range(4)]
    if name == "lif_bwd":
        return lambda: lif_bwd_cuda(cur, tau, lane[0], sp, gs, lane[1])
    if name == "alif_bwd":
        return lambda: alif_bwd_cuda(cur, tau, rho, lane[0], lane[1], sp, gs,
                                     lane[2], lane[3])
    if name in ("lifrec_bwd", "alifrec_bwd"):
        w = (0.4 / N ** 0.5) * (rand(N, N) - 0.5)
        s0 = rand(B, N, p=0.2)
        if name == "lifrec_bwd":
            return lambda: lifrec_bwd_cuda(cur, w, tau, lane[0], s0, sp, gs,
                                           lane[1])
        return lambda: alifrec_bwd_cuda(cur, w, tau, rho, lane[0], lane[1],
                                        s0, sp, gs, lane[2], lane[3])
    if name == "linrec_bwd":
        a = 0.5 + 0.49 * (rand(T, B, N) if d["P"] == 2 else rand(N))
        gy = rand(T, B, d["G"])
        return lambda: linrec_bwd_cuda(a, cur, lane[0], gy, lane[1])
    raise AssertionError(f"verifier: no inputs for backward {name!r}")


def verifier_path_shapes():
    """{family: [(label, dims)]}: the kernels' calls on the served paths
    (one SHD DH-SNN window, one ECG window, a learning serve window)."""
    B, T = CAPACITY, WINDOW
    lanes = {"T": T, "B": B, "P": 1}
    return {
        "spikemm": [("shd hidden INTEG", {"M": T * B, "K": N_IN,
                                          "N": N_HIDDEN * N_BRANCHES}),
                    ("shd readout INTEG", {"M": T * B, "K": N_HIDDEN,
                                           "N": N_OUT}),
                    ("ecg hidden INTEG", {"M": T * B, "K": ECG_IN,
                                          "N": ECG_HIDDEN})],
        "linrec": [("shd branches", {**lanes, "N": N_HIDDEN * N_BRANCHES,
                                     "L": B * N_HIDDEN * N_BRANCHES}),
                   ("shd readout", {**lanes, "N": N_OUT, "L": B * N_OUT})],
        "lif": [("shd soma", {**lanes, "N": N_HIDDEN, "L": B * N_HIDDEN})],
        "alifrec": [("ecg hidden", {"T": T, "B": B, "N": ECG_HIDDEN})],
        "lifrec": [("ecg_homogeneous hidden", {"T": T, "B": B,
                                               "N": ECG_HIDDEN})],
        # train_shd's step (TRAIN_T x TRAIN_B) and train_ecg's
        "lif_bwd": [("train_shd soma", {"T": TRAIN_T, "B": TRAIN_B,
                                        "N": N_HIDDEN, "P": 1,
                                        "L": TRAIN_B * N_HIDDEN})],
        "linrec_bwd": [("train_shd branches",
                        {"T": TRAIN_T, "B": TRAIN_B,
                         "N": N_HIDDEN * N_BRANCHES, "P": 1,
                         "L": TRAIN_B * N_HIDDEN * N_BRANCHES,
                         "G": N_HIDDEN, "GA": 2, "V": 1})],
        "alifrec_bwd": [("train_ecg hidden", {"T": ECG_TRAIN_T,
                                              "B": ECG_TRAIN_B,
                                              "N": ECG_HIDDEN})],
        "spikemm_wgrad": [("train_shd hidden g_w",
                           {"R": TRAIN_T * TRAIN_B, "K": N_IN,
                            "N": N_HIDDEN * N_BRANCHES})],
    }


def verifier_tiles():
    """Every family's tile model against the card's launches (see the
    module docstring, 16 (c))."""
    from repro_torch import analysis
    from repro_torch.kernels import registry
    from repro_torch.kernels.common import plan_sms, smem_budget
    budget, n_sm = smem_budget(), plan_sms()
    paths = verifier_path_shapes()
    rows = []
    specs = [registry.get(name) for name in registry.names()]
    specs += [s.bwd_tiles for s in specs if s.bwd_tiles is not None]
    for spec in specs:
        name = spec.name
        dims0 = spec.dims_of(*spec.make_inputs(torch.Generator().manual_seed(
            0)), **spec.static)
        shapes = analysis.route_shapes(spec, dims0, n_sm=n_sm)
        shapes += [(label, d, spec.resolve_blocks(d, n_sm=n_sm))
                   for label, d in paths.get(name, [])]
        for label, d, blocks in shapes:
            fn = (verifier_inputs(name, d, blocks) if name in registry.names()
                  else verifier_bwd_inputs(name, d))
            model = spec.launches(d, blocks)
            got = graph_launches(fn)
            traced = trace_launches(fn)
            tag = f"verifier [tiles] {name} {label} {d}"
            for m in model:
                hits = [x for x in got if _mangled(m.kernel, x[0])]
                if len(hits) != 1:
                    raise AssertionError(f"{tag}: {len(hits)} launches of "
                                         f"{m.kernel} in {got}")
                _, grid, block, dyn, static = hits[0]
                launched = dyn + static
                # Kineto's event, where the trace recorded the kernel: its
                # grid and its shared memory (static + dynamic) must be the
                # graph's
                tev = [a for n_, a in traced if _demangled(m.kernel, n_)]
                t_grid = tuple(tev[0].get("grid", ())) or None if tev else None
                t_smem = _trace_smem(tev[0]) if tev else None
                if (t_grid, t_smem) != (None, None) and (
                        t_grid != grid or t_smem != launched):
                    raise AssertionError(
                        f"{tag}: {m.kernel} traced grid {t_grid}, shared "
                        f"memory {t_smem}; graph {grid}, {dyn} + {static}")
                if tuple(m.grid) != grid or block != (m.threads, 1, 1):
                    raise AssertionError(
                        f"{tag}: {m.kernel} launched grid {grid} block "
                        f"{block}, its model {m.grid} x {m.threads}")
                if m.smem < launched:
                    raise AssertionError(
                        f"TB304 {tag}: {m.kernel} launched {dyn} + {static} "
                        f"B of shared memory, its model {m.smem}")
                if m.smem > TB305_RATIO * max(launched, 1) and launched:
                    raise AssertionError(
                        f"TB305 {tag}: {m.kernel}'s model {m.smem} B is over "
                        f"{TB305_RATIO}x its launch's {launched}")
                if launched > budget:
                    raise AssertionError(f"{tag}: {m.kernel} launched "
                                         f"{launched} B > budget {budget}")
                rows.append({"family": name, "case": label, "dims": d,
                             "blocks": blocks, "kernel": m.kernel,
                             "grid": list(grid), "threads": block[0],
                             "smem_dynamic": dyn, "smem_static": static,
                             "model_smem": m.smem,
                             "traced_grid": list(t_grid) if t_grid else None,
                             "traced_smem": t_smem})
                log(f"{tag}: {m.kernel} grid {grid} x {block[0]} threads, "
                    f"shared memory {dyn} + {static} B (model {m.smem} B; "
                    f"trace grid {t_grid}, shared memory {t_smem})")
            # the route's hand kernels (the sources' anonymous namespaces;
            # PyTorch's own kernels, a W^T copy or a sum, are not the model's)
            extra = [x[0] for x in got if "_GLOBAL__N_" in x[0]
                     and not any(_mangled(m.kernel, x[0]) for m in model)]
            if extra:
                raise AssertionError(f"verifier [tiles] {name} {label}: "
                                     f"launches outside the model {extra}")
    traced = sum(r["traced_grid"] is not None for r in rows)
    log(f"verifier [tiles]: {len(rows)} launches of {len(specs)} kernel "
        f"specs ({len(registry.names())} families and their backward "
        f"kernels) held to their models (grid equal, shared memory within "
        f"the model and {TB305_RATIO}x of it, within the budget {budget} B); "
        f"geometry read from the CUDA graph for all, and from the Kineto "
        f"trace, equal, for the {traced} whose trace recorded the kernel")
    return {"launches": rows, "budget": budget, "traced": traced}


def verifier_flags():
    """TB307 on the occupancy flags the card measures at sparse_integ's
    densities."""
    from repro_torch import analysis
    from repro_torch.kernels._build import SPARSE_BLOCK
    from repro_torch.kernels.spikemm.sparse import (block_occupancy,
                                                    occupancy_cuda)
    out = {}
    for density in VERIFIER_DENSITIES:
        s = torch.from_numpy(packed_raster(SPARSE_T * SPARSE_B, SPARSE_IN,
                                           density, SPARSE_SEED)).to(DEV)
        flags, total = occupancy_cuda(s)
        want = block_occupancy(s, *SPARSE_BLOCK)
        sync()
        if not torch.equal(flags, want) or int(total) != int(want.sum()):
            raise AssertionError(f"verifier: occupancy flags at density "
                                 f"{density} are not block_occupancy's")
        diags = analysis.check_flags(f"sparse_integ[{density}]", flags)
        if diags:
            raise AssertionError(analysis.render(diags))
        out[str(density)] = {"blocks": flags.numel(),
                             "occupied": int(total)}
        log(f"verifier [TB307]: density {density}: {int(total)} of "
            f"{flags.numel()} blocks occupied on the card's flags, "
            "compact_blocks' table faithful")
    return out


def phase_verifier(smi):
    """16. verifier (see the module docstring)."""
    from repro_torch.kernels import registry
    cli = verifier_cli()
    compiles = compile_ms()
    registry.reset_launches()
    served = verifier_served()
    tiles = verifier_tiles()
    flags = verifier_flags()
    return {"path": "verifier", "model": PATHS[0].model,
            "card": smi, "cli": cli, "compile_ms": compiles,
            "launches": served["launches"],
            "launches_per_window": served["launches_per_window"],
            "served": {k: v for k, v in served.items()
                       if k not in ("launches", "launches_per_window")},
            "tiles": {"launches": len(tiles["launches"]),
                      "traced": tiles["traced"], "budget": tiles["budget"]},
            "tile_launches": tiles["launches"], "tb307": flags}


def phase_parity():
    """`repro_torch.kernels.parity.check_all()` on the card: every family's
    wrapper (and the sparse channel's) against its plain version at its
    `make_inputs`, `attention` with its VJP. Its launches are comparisons
    and count toward no path."""
    from repro_torch.kernels import parity
    reports = parity.check_all()
    n = 0
    for name, rep in reports.items():
        for kname, r in [(name, rep)] + list(rep.get("channels", {}).items()):
            n += 1
            log(f"parity {kname}: forward max abs err "
                f"{r['forward_max_err']:.3e}"
                + (f", VJP {r['vjp_max_err']:.3e}" if "vjp_max_err" in r
                   else ""))
    # the backward kernels are held inside their families' VJP legs
    forward = [k for k in SOURCES if k not in BWD_ONLY]
    if n != len(forward):
        raise AssertionError(f"parity checked {n} kernels, the table has "
                             f"{len(forward)} forward kernels")
    for fam in BWD_FAMILIES + ("spikemm", "spikemm_gather"):
        rows = [reports[fam]] + list(reports[fam].get("channels",
                                                      {}).values())
        if any("vjp_max_err" not in r for r in rows):
            raise AssertionError(f"parity: {fam}'s VJP was not checked")
    log(f"parity OK for {n} kernels")
    return reports


def path_phases():
    """Each path's phase by its name, as `--path` takes it."""
    return {**{p.name: functools.partial(phase_path, p) for p in PATHS},
            "alif_ff": phase_alif_ff,
            "topology_banded": phase_topology_banded,
            "sparse_integ": phase_sparse_integ,
            "plastic_ff": phase_plastic_ff,
            "plastic_online": phase_plastic_online,
            "stdp_step": phase_stdp_step,
            "serve_plastic": phase_serve_plastic,
            "resilience": phase_resilience,
            **{name: functools.partial(phase_train, p)
               for name, p in train_paths().items()},
            "bci": phase_bci,
            "attention": lambda smi: phase_attention(smi)[1],
            "verifier": phase_verifier}


def main(argv):
    one_path = len(argv) == 2 and argv[0] == "--path" \
        and argv[1] in path_phases()
    if argv not in ([], ["--sweep"], ["--kernels"]) and not one_path:
        raise SystemExit(f"chip_smoke: unknown arguments {argv}; run it with "
                         f"none, --sweep, --kernels or --path NAME (one of "
                         f"{', '.join(path_phases())})")
    smi = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    build_s = phase_build()
    if one_path:
        # one path alone: no kernel phase, no sweep
        log(json.dumps({"slice": path_phases()[argv[1]](smi)}))
        log(smi)
        return
    if argv == ["--sweep"]:
        # the serial-chain kernels alone: their sweep, no paths
        log(json.dumps({"sweep": phase_sweep(sweep_cases())}))
        log(smi)
        return
    # the verifier first: its Kineto traces record every kernel in a fresh
    # process (later, after the other phases' profiler sessions, most of
    # them come back empty; its CUDA-graph readout needs no trace)
    verifier = None if argv == ["--kernels"] else phase_verifier(smi)
    cases = kernel_cases(make_shd(True, DEV)[1])
    kernels = phase_kernels(cases)
    passes = phase_rec_bwd_passes(cases)
    for name in LANE_BWD_HOME:
        passes.update(phase_lane_bwd_passes(cases, name))
    passes.update(phase_wgrad_passes(cases))
    gather_rows = phase_gather_rows(cases["spikemm_gather"])
    sparse = {c.label: c.args for c in cases["spikemm_sparse"]}
    sparse_sync_checks(*sparse[SPARSE_HOME_CASE], *sparse[SPARSE_DENSE_CASE])
    wgrad_sync_checks(cases["spikemm_wgrad"])
    sparse_tiles = phase_sparse_tiles(cases["spikemm_sparse"])
    sweep = phase_sweep(cases)
    if argv == ["--kernels"]:
        # the kernel phase and the sweep alone, no paths (no launch counts)
        log(json.dumps({"kernels": list(kernels.values())}))
        log(json.dumps({"bwd_passes": passes}))
        log(json.dumps({"gather_rows": gather_rows}))
        log(json.dumps({"sparse_tiles": sparse_tiles}))
        log(json.dumps({"sweep": sweep}))
        log(smi)
        return
    slices = [phase_path(p, smi) for p in PATHS]
    slices.append(phase_alif_ff(smi))
    slices.append(phase_topology_banded(smi))
    slices.append(phase_sparse_integ(smi))
    slices.append(phase_plastic_ff(smi))
    slices.append(phase_plastic_online(smi))
    slices.append(phase_stdp_step(smi))
    slices.append(phase_serve_plastic(smi))
    slices.append(phase_resilience(smi))
    slices += [phase_train(p, smi) for p in train_paths().values()]
    slices.append(phase_bci(smi))
    kernels["attention"], attn = phase_attention(smi)
    kernels["attention"]["floor_ms"] = launch_floor_ms()
    slices.append(attn)
    slices.append(verifier)
    parity = phase_parity()
    for name, k in kernels.items():
        by_path = {s["path"]: s["launches"][name] for s in slices
                   if s["launches"][name]}
        if not by_path:
            raise AssertionError(f"kernel {name} launched on no path")
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        # per served window or streamed chunk; for alif_ff, per plan.run
        # of its 250 steps; for sparse_integ, per plan.run of each density
        k["launches_per_window"] = {
            s["path"]: s.get("launches_per_window",
                             s.get("launches_per_run"))[name]
            for s in slices if s["path"] in by_path}
    slices[0]["build_s"] = build_s["build_s"]
    slices[0]["build"] = build_s
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"bwd_passes": passes}))
    log(json.dumps({"gather_rows": gather_rows}))
    log(json.dumps({"sparse_tiles": sparse_tiles}))
    log(json.dumps({"sweep": sweep}))
    for s in slices:
        log(json.dumps({"slice": s}))
    log(json.dumps({"parity": parity}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
