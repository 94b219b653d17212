#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``deeplearning4j_tpu_torch`` (never the JAX package, never JAX) on
the card and exits nonzero if any phase fails:

1. build  : compiles every CUDA kernel source of the port with ``nvcc``
            (one process per source, all started together) and prints the
            build time and each kernel's register use; conv_stats' wgmma
            instances must not spill and must hold ``HGMMA`` instructions
            (``cuobjdump -sass`` of the built library, counted);
2. kernels: every kernel against its plain PyTorch version on the card, in
            float32 and bfloat16, at the serving/training shape (B=64,
            T=256, H=512), at ragged shapes and B > 64 (two launches), and
            at the edges of the recurrent row-group kernels (B = 16, 17, 33;
            H = 8, 1024; H = 100 for the CUDA-core kernels in bf16), with a
            random mask holding all-zero rows for the peephole/mask cell:
            the inference forward, the saving forward (ys, hT, cT and the
            residuals), and the backward (ds, dh0, dc0, on the same
            residuals), each LSTM check with four more launches bit for bit
            and the kernel the profiler names (``lstm_fwd_mma_kernel``/
            ``lstm_bwd_mma_kernel`` for bf16 with H % 8 == 0, the CUDA-core
            ``lstm_fwd_kernel``/``lstm_bwd_kernel`` otherwise); then the
            whole autograd wrapper's float32 gradients against
            ``torch.autograd`` of the plain forward. Max error beside the
            tolerance. The flash-attention kernel, both instances
            (inference: o; saving: o and lse), against its plain version in
            float32 and bfloat16 at BERT-base serving's shape (with and
            without a key-padding mask holding a length-1 row and a fully
            masked row), at T=4096 causal (also with a mask), and at ragged,
            cross-attention, d_v != d, d and d_v no multiple of 16, and d=256
            shapes, and on views one element into their buffers (the bf16
            kernel then stages element by element; each line names the
            staging). The flash backward kernels (dq;
            dk/dv) against the plain backward on the same o and lse, in
            float32 and bfloat16, at the same shapes, at T=16384 causal
            (the TPU's chunked-backward regime) and on views one element
            into their buffers, max error relative to the largest plain
            gradient, a second launch bit for bit, each line naming the
            kernels and staging taken; the autograd Function's float32
            gradients against ``torch.autograd`` of the plain forward. The
            GRU kernels (inference forward; saving forward: ys, hT, gates,
            zh_n; backward: dzx, dh0 on the same residuals) against
            ``gru_reference``/``gru_bwd_reference`` in float32 and bfloat16
            at the same shapes and at two more edges of the GRU's row-group
            plan (H = 1024 with 32 and 64 rows), each with four more
            launches bit for bit and the kernels the profiler names
            (``gru_fwd_mma_kernel``/``gru_bwd_mma_kernel`` for bf16 with
            H % 8 == 0 where a plan fits, the CUDA-core
            ``gru_fwd_kernel``/``gru_bwd_kernel`` otherwise),
            ``FusedGRUFunction``'s float32 gradients
            (dzx, dW_rec, dh0) against ``torch.autograd`` of
            ``gru_reference``, and one ``Bidirectional(GRU)`` forward against
            the plain loop (2 launches). The dropout kernel against its plain
            version, bitwise (the same Philox bits), forward, backward and
            the same seed again, in float32 and bfloat16, with and without
            the residual x, at rates 0.1, 0.5 and 0, at 8192 x 768, ragged
            shapes, one element and a 4k+3 tail, and through unaligned views;
            the backward's mask against the forward's, the keep fraction, and
            seed + 1 giving another mask. The short-attention forward and
            backward kernels against their plain versions in float32 and
            bfloat16, in both layouts, at BERT-base's shape (with a mask
            holding a length-1 and a fully masked row, and without), t = 512,
            t = 1, odd t and d of 24, 32, 33, 64, 128 and 256 (both designs
            of the bf16 forward: score rows in registers at t <= 128, two
            passes beyond), on views one element into their buffers, and the
            autograd Function's float32 gradients against ``torch.autograd``
            of the plain forward.
            conv_stats (TPU row 13: a 1x1 convolution as a product, with
            BatchNormalization's shifted per-channel sums in its epilogue)
            against its plain version in float32 and bfloat16 with a nonzero
            shift at row 13's shape, one shape of each other ResNet-50 stage,
            the widest M at N = 64, a ragged M at row 13's width and two
            ragged shapes, and a bf16 x one element into its buffer; a
            second launch bit for bit; the profiler names the kernel each
            case ran (``conv_stats_wgmma_kernel`` for every aligned bf16
            shape, ``conv_stats_kernel`` for float32 and unaligned bf16);
3. slice  : the serving path at full width. ``TextGenerationLSTM(vocab 96,
            hidden 512, 2 layers)`` with random weights from a seed, in
            bf16 compute, is written to an archive, loaded by
            ``ModelRegistry.load`` and served to 8 client threads sending
            requests of 1-64 rows at T=256. Every answer is held against a
            forward pass built from the plain versions; the launch counts
            of the run must show the inference kernels ran; ``rnn_time_step``
            over 4 chunks of 64 steps must equal the whole-sequence output;
            the profiler must name the forward kernel of one 64-row request,
            2 launches (``lstm_fwd_mma_kernel``, ``gru_fwd_mma_kernel``).
            Once with ``graves=True`` (GravesLSTM, kernels of
            ``fused_lstm_graves``) and once with ``graves=False`` (LSTM,
            kernels of ``fused_lstm``). Then ``slice bert``: ``Bert.base()``
            (L=12, H=768, A=12) with random weights from its zoo seed, bf16
            compute, through an archive and ``ModelRegistry.load``, serving
            8 client threads requests of 1-64 rows of T=128 token ids: every
            answer against the forward with the plain attention, 12 flash
            launches per batch, masked rows against the same rows cut to
            their tokens, p50 of a 64-row request and samples/s. Then
            ``slice gru``: the same char-RNN with GRU cells, built with the
            builder DSL, served the same way (2 ``fused_gru`` launches per
            batch and nothing else launched);
4. train  : the training path at full width. The same network with
            ``tbptt_length=256`` is trained by ``fit`` in bf16 compute on 20
            seeded batches of B=64, T=256 (``bench_char_rnn``'s shape); the
            launch counts must show one saving forward and one backward per
            layer per step and nothing of the other cell, the profiler must
            name them in one more step (``lstm_fwd_mma_kernel`` and
            ``lstm_bwd_mma_kernel`` x 2), and the loss must fall. It prints
            step ms and tokens/s. The first 3 steps' losses
            are held, in float32 and bfloat16, against the same training
            with the recurrences computed by the plain forward under
            autograd. Once per cell, as the slice phase. Then ``train
            bert``: ``Bert.base()`` fine-tuned by ``fit`` at B=64, T=128
            (an all-ones features mask, Adam(2e-5), dropout 0.1, bf16
            compute over fp32 weights) for 20 seeded steps of random ids:
            12 saving-forward, 12 dq and 12 dk/dv flash launches per step
            and no inference launch, the first 3 losses in float32 and
            bfloat16 against a
            trainer whose attention runs the plain forward and backward,
            step ms, samples/s, a device-busy breakdown of one step; then
            20 steps on balanced labels with each row made of its label's
            token, where the loss must fall below the first step's and
            chance and the trained net must label a fresh batch; and the
            statistics of the dropout masks drawn on the card. Then
            ``samediff bert`` (BASELINE config #4 as ``bench_imported_bert``
            runs it): BERT-base built through the port's SameDiff as the JAX
            package's TF import yields it (``build_bert_samediff``, seed 0),
            ``optimize()`` (25 LayerNorm, 12 gelu and 12 attention fusions,
            every padding bias proven), ``graft_classifier``,
            ``convert_to_variable`` and ``fit`` over ``ExistingDataSetIterator``
            of 20 MultiDataSets of ``bert_synthetic_batch(64, 128, 30522,
            seed=1)`` under Adam(2e-5), bf16 over fp32 masters: 12 saving
            forwards, 12 dq and 12 dk/dv flash launches a step and nothing
            else; step ms, samples/s, peak memory and a device-busy breakdown
            beside the zoo ``train bert`` step of the same run, and the
            FFN-wide elementwise ops' share of a step; the first 3 losses in
            fp32 and bf16 against the same fit with the plain attention;
            ``sd.output(pooled_output)`` (fp32) against the plain attention
            and its p50; 20 steps on every_token's labels, where the loss
            must fall and a fresh batch be labelled. ``--samediff`` runs the
            build, ``train bert`` and this phase only. Then ``tf import``
            (config #4 by the reference's route): the committed BERT-base
            GraphDef (``tests/data/bert_base_b64_t128.pb``: B=64, T=128,
            vocab 30522, its 76 weight matrices stripped) decoded by the
            port's reader, refilled from ``bert_weights(seed=0)``, imported
            by ``TFGraphMapper`` (op list, variables and arrays those of
            ``build_bert_samediff(seed=0)``), ``optimize()``d (25 / 12 / 12
            fusions, as the builder's), grafted and fit 20 steps as above:
            12 + 12 + 12 flash launches a step and nothing else, the first 3
            losses bit for bit the builder route's from the same weights;
            step ms, samples/s, peak memory, the import's wall time by
            decode, refill, import and optimize; the importer's seeded
            draws (``random_uniform``, ``random_normal``,
            ``truncated_normal``, ``random_categorical``) drawn on the card
            by a generator there, held by law. ``--tf-import`` runs the
            build and this phase only. Then ``train
            gru``: the GRU char-RNN as the LSTM cells are trained (1 saving
            forward and 1 backward GRU launch per layer per step, nothing
            else launched).
            ``--label-rules`` runs the build and 20 steps under each of
            several label rules instead. Then ``resnet``: ``ResNet50(1000
            classes)`` trained by ``fit`` as ``bench_resnet`` trains it
            (batch 256 at 224x224, bf16 compute, Nesterovs(0.1, 0.9), one
            synthetic batch repeated) for 20 steps: 36 conv_stats launches a
            step from ``fit`` itself (every 1x1 convolution +
            BatchNormalization pair) and nothing else, all 36 of them
            ``conv_stats_wgmma_kernel`` by the profiler, step ms, img/s, peak
            memory, a device-busy breakdown, the loss falling, every
            BatchNormalization's running statistics moving; the trained net
            through an archive and ``ModelRegistry`` (p50 of 20 sequential
            64-row requests, answers against the net's own output); the
            first 3 losses against the same net with conv_stats' plain
            version. ``--resnet`` runs the build, the conv_stats checks,
            this phase and conv_stats' times only. Then ``lenet``
            (BASELINE config #1): the zoo ``LeNet()`` at full width (28x28x1,
            conv 20 and 50 5x5 same, dense 500, softmax 10, Adam(1e-3),
            seed 123), fp32 with TF32 off, trained by ``fit`` for one epoch
            of ``MnistDataSetIterator(64, train=True)`` (the 60000
            synthetic images: 938 steps), no kernel of the port launched
            (cuDNN and cuBLAS only); step ms, img/s, peak memory, a
            device-busy breakdown of one step and PerformanceListener's
            reports; ``evaluate`` on the 10000 test images (accuracy >=
            0.95, ``stats()`` printed); the first 3 losses against the same
            net on the CPU from the same archive and batches (<= 1e-4),
            and 3 steps likewise under AdaMax, AMSGrad, Nadam, AdaGrad,
            AdaDelta, Sgd under a StepSchedule and Adam with
            ClipL2PerLayer, l2 and weight decay; the trained net with an
            ``ImagePreProcessingScaler`` through an archive
            (``restore_normalizer`` gives it back) and ``ModelRegistry``: 8
            clients x 3 requests of 1-64 rows of 784 floats, each answer
            against ``net.output`` (<= 1e-4), the p50 of 20 sequential 64-row
            requests and samples/s. ``--lenet`` runs the build and this
            phase only. Then ``solvers``: LBFGS, CONJUGATE_GRADIENT and
            LINE_GRADIENT_DESCENT (fp32, TF32 off) on the zoo LeNet over
            the first 5 MNIST batches, layer 0 frozen; LINE_GRADIENT_DESCENT
            on the GravesLSTM char-RNN (2x512, B=64, T=256, output layer
            frozen) and CONJUGATE_GRADIENT on the LSTM char-RNN built as a
            ComputationGraph, 2 batches of 4 iterations each: the loss
            falls, frozen layers stay bit for bit, the saving forward and
            backward of the recurrent kernel launch once per layer in every
            value-and-gradient evaluation (and the inference forward once
            per layer in each batch's final forward), the first batch's
            values within 1e-4 of the port's CPU run from the same archive
            (LeNet's through the final loss, the char-RNNs' through their
            first iteration); batch ms, evaluations and the accepted
            steps of card and CPU. ``--solvers`` runs the build and this
            phase only.
            ``--recurrent`` runs the
            build, the LSTM and GRU checks, the slice and train phases of
            the three char-RNNs and the times of rows 1-6 only.
            ``--attention`` runs the
            build, the flash and short-attention checks, ``slice bert``,
            ``train bert``, ``ops`` and the times of rows 7, 8-9 and 11-12
            only;
5. ops    : the entry points of the last three TPU kernels, which no layer
            routes to, driven under autograd as ``bench.py:572-626``
            (``verify_kernels``) drives the JAX package's:
            ``short_attention`` and ``short_attention_btd`` at (64, 12, 128,
            64) bf16, forward and gradient against a dense fp32 softmax, and
            ``fused_dropout`` at 8192 x 768 bf16, rate 0.1 (zero fraction,
            the gradient's mask); one forward and one backward launch of each;
6. times  : each LSTM kernel's time at B=64, T=256, H=512 bf16 by its own
            device time (``torch.profiler``; back-to-back CUDA events beside
            it), per step, the kernel the profiler names, beside its bound
            and the share of it reached, its plain version's time and, for
            the plain cell, ``torch.nn.LSTM`` (cuDNN) inference, training
            forward and backward as a yardstick the port never calls; the
            kernels' share of a training step and of a serving request. The
            GRU kernels likewise, beside ``torch.nn.GRU`` (cuDNN), with their
            share of a serving request and of a training step. The flash kernel in bf16 at
            BERT-base serving's shape (unmasked as served, and masked) and
            at T=4096 causal, by its own device time (``torch.profiler``;
            back-to-back CUDA events beside it), beside its bound and the
            share of it reached, its saving instance, its plain version and
            ``scaled_dot_product_attention``'s device time (a yardstick the
            port never calls); its share of a BERT request and of a
            fine-tuning step. The
            backward pair at BERT-base's shape (masked, as trained, and
            unmasked), at T=4096 causal and at T=16384 causal, by each
            kernel's own device time (``torch.profiler``) beside its bound
            and the share of it reached, the plain backward and
            ``scaled_dot_product_attention``'s backward by device time;
            attention's share of a BERT training step. The dropout kernel
            (forward, backward, and with x) beside ``F.dropout``, and the
            short-attention kernels in both layouts by device time beside
            ``scaled_dot_product_attention``'s, at the ops phase's shapes.
            conv_stats at each of the 15 distinct shapes of ResNet-50's
            step by device time (back-to-back CUDA events beside it) beside
            its bound and ``torch.matmul`` plus the two fp32 column sums
            (device time), its plain version at row 13's shape, and the sum
            over the step's 36 launches beside the profiler's conv_stats
            total in the step.
7. runtime: (after ``lenet``; ``--runtime`` runs the build and this phase
            only) the training runtime under every fit loop, with captured
            CUDA graphs (``runtime/compile_cache.AotCache``) replayed by the
            fit loops. Config #4 as ``bench_imported_bert`` runs it, one
            epoch of 48 repeated batches three ways: ``dispatch_unroll(4)``
            (a 4-step graph), one-step graphs, and ``aot_dispatch`` off: each
            one's steady step ms, samples/s, device busy and its share, peak
            memory, 576 saving flash forwards, 576 dq and 576 dk/dv, and its
            losses and final weights against the eager run's (1e-6
            relative). LeNet one epoch fp32 with and without graphs: step ms,
            busy share, test accuracy >= 0.95, the first 3 losses against
            the CPU. ResNet-50 for 20 steps with ``prefetch_buffer=2`` and a
            ``TrainingProfiler`` (data wait / dispatch / step) against
            ``prefetch_buffer=0``: the same losses, 720 conv_stats launches.
            The zoo BERT (dropout 0.1) with ``dispatch_unroll(4)``, 5 fits
            of one group: the dropout masks a replayed graph wrote differ
            from step to step and replay to replay, drop share in (0.08,
            0.12), the first 3 losses against the plain attention, the loss
            falling. A ``FaultTolerantTrainer`` on LeNet with a chaos fault
            mid-epoch: restarted from the last checkpoint, the final weights
            of an uninterrupted run, ``verify_checkpoint``. Early stopping
            on LeNet (at most 3 epochs): the best epoch and score.
            ``GradientCheckUtil`` in float64 on the card: conv +
            BatchNormalization + dense passes, an LSTM net raises by the
            kernels' dtype rule. Then the graphs captured and replayed.
8. parallel: (after ``runtime``; ``--parallel`` runs the build and this
            phase only) config #5 over meshes that repeat cuda:0, one
            process driving every replica. ``ParallelWrapper`` on
            ``Bert.base()`` (dropout 0, Adam(2e-5), bf16 over fp32 weights,
            10 steps of ``bert_synthetic_batch(64, 128, 30522, seed=1)``)
            data parallel, FSDP and tensor parallel over 2 x cuda:0: 2 x 12
            saving forwards, dq and dk/dv a step (one set per replica or
            tensor piece) and nothing else, step ms, samples/s, peak memory,
            a device-busy breakdown of a data-parallel step; each plan's
            ``compose()`` twin bit for bit (deterministic kernels on); data
            parallel's losses and weights against the net's own fit. The
            pipe plans on ``bench_parallel``'s net over 8 x cuda:0:
            ``compose(data=2, pipe=4)`` at microbatches 1 bit for bit
            against data=2, at 4 within 2e-5. The distributed trainer at
            ``bench_distributed``'s shape: world-2 loopback, then two
            processes over gloo both computing on cuda:0, at threshold 0 and
            1e-3, bit for bit against loopback, the encoded bytes >= 5x
            smaller than dense, the encode/exchange/decode/apply split; then
            world-2 loopback on ``Bert.base()`` at 1e-3 (the codec at 110M
            parameters). Ring attention over seq=4 x cuda:0 at (1, 12, 4096,
            64) bf16 against a dense fp32 softmax (<= 0.05), causal and not.
            One card measures no scaling: the replicas run one after another.
9. zoo    : (after ``parallel``; ``--zoo`` runs the build, the conv_stats and
            recurrent kernel checks and this phase only) the rest of config
            #2's family. ``YOLO2()`` at the zoo's defaults (80 classes,
            416x416x3, 5 anchors, Nesterovs(1e-3, 0.9)), bf16 over fp32
            weights, its gradients renormalized per layer as the reference's
            YOLO2 trains (the zoo's updater alone diverges on the summed
            detection loss), trained by ``fit`` for 20 steps at batch 32 on one
            synthetic detection batch (1-4 objects an image, the JAX label
            layout): 7 conv_stats launches a step (its plain 1x1
            convolution + BatchNormalization pairs, named) and nothing else,
            all ``conv_stats_wgmma_kernel`` by the profiler, conv_stats'
            share of the step's device time, step ms, img/s, peak memory, a
            device-busy breakdown, the loss falling, every
            BatchNormalization's statistics moving, the first 3 losses
            against the plain conv_stats; the trained net through
            ``ModelRegistry`` (p50 of 20 sequential 16-row requests, answers
            against ``net.output``) and one served batch decoded by
            ``activate_boxes``. Every other zoo CNN at its published input
            size (SimpleCNN 48, AlexNet, VGG16/19, SqueezeNet and Darknet19
            224, Xception 299, InceptionResNetV1 160, UNet 128, TinyYOLO
            416): one forward and 2 ``fit`` steps at batch 2 in fp32 (TF32
            off), card against CPU from one archive (1e-3 relative; dropout
            retained at 1.0 in both; for Darknet19, Xception and
            InceptionResNetV1, whose second loss parts between the CPU's own
            two convolution paths, a second loss beyond that against the
            CPU's float64 steps), then its forward ms at batch 32 in bf16. VGG16 (224, bf16) frozen up to its last hidden dense layer
            with a new 5-class head (``TransferLearning``, Adam(1e-2)), 10
            steps at batch 32: the loss falls, the frozen layers bit for bit
            unchanged. Config #3's char-RNN as a ``ComputationGraph`` from
            the ``MultiLayerNetwork``'s weights: ``rnn_time_step`` in 4
            chunks of 64 against the whole sequence and against the
            network's, tBPTT ``fit`` (length 64, 5 windows) against the
            network's first 3 losses, the LSTM kernels counted. ResNet-50 as
            the resnet phase trains it, 5 steps with ``set_remat(True)`` and
            5 without from the same weights: peak memory, step ms,
            conv_stats launches a step (a recomputed segment's pairs launch
            again) and the losses.

10. serving: (after ``zoo``; ``--serving`` runs the build and this phase only)
            serving's device side. ``Bert.base()`` bf16 from an archive
            through ``ModelRegistry.load`` with a warm-up example, buckets
            1-64, 2 replicas on cuda:0 (``devices=[cuda:0, cuda:0]``), 2
            batches in flight: one captured CUDA graph per (bucket,
            replica) after warm-up and the same count after traffic; 8
            clients x 3 requests of 1-64 rows against the plain attention's
            forward (<= 2e-2), 12 flash launches a batch through replays;
            answers bit for bit across the replicas, against depth 0,
            against eager ``output`` at the bucket shape, and under 8
            clients of full-bucket requests with both replicas replaying at
            once; p50 of 20 sequential 64-row requests, its device busy
            time (``torch.profiler``) and host share, and samples/s with
            p50/max latency of 8 clients, beside the synchronous eager arm
            (depth 0, ``aot_dispatch`` off, one replica). The GravesLSTM
            and GRU char-RNNs (rows 1 and 5) the same way, 2 launches a
            batch. ``SessionStore`` over the LSTM char-RNN (row 3): 16
            streams x 8 steps of 32 tokens at the session bucket 16, every
            stream bit for bit its serial ``rnn_time_step`` loop padded to
            16 rows, 2 launches a step batch, step p50. The lifecycle: a
            1 ms deadline, a burst past ``queue_limit=4`` (``Overloaded``
            with ``retry_after_ms``), a forward chaos fault failing only its
            batch, the breaker open / half-open / closed, a hot-swap under
            8 clients capturing nothing on traffic, a saved manifest
            replayed by a fresh registry, ``add_replica``/``remove_replica``
            under traffic, ``undeploy`` draining.

11. residency: (after ``serving``; ``--residency`` runs the build and this phase only)
            serving's device side, second half. Paging: two ``Bert.base()``
            archives of different seeds and a byte copy of each (m0-m3),
            bf16, T=128, registered cold (``load(resident=False)``), 1
            replica each at buckets 1, 8, 64, under a budget of 2.5 x one
            model's ledger bytes from an unbudgeted probe registry; 3
            threads x 8 requests of 1-64 rows rotating over the names: the
            ledger after every request within the budget, no request
            failed, every answer bit for bit its model's before any
            eviction at a bucket it may be served at, graphs captured = the
            manifest's 3 pairs x page-ins (nothing on traffic), 12 flash
            launches a replay; a 30 ms deadline on a cold model
            (``PagingInProgress``, ``retry_after_ms`` >= the measured
            page-in cost less the time spent); 3 evict/page-in cycles of
            m0 (each eviction frees at least the ledger's bytes of
            ``memory_allocated``, which after the last is within 16 MiB of
            the first). Quantized deploys: ``quantize_archive`` of m0
            (weights only, ``quantized_buckets=[]``) in both residencies;
            f32, dequantized and int8 residency each: ledger and
            ``memory_allocated`` bytes with the graphs, p50 of 20 sequential
            64-row requests, answers vs the same model's forward from the
            plain versions (<= 2e-2), flash launches; ``deploy_quantized``
            over the serving f32 m0 with gates of max_delta -1 (refused, f32
            serving 4 clients on) and 1 (deployed), top-1 agreement on 256
            golden rows through the serving paths. int8 request rows: the
            GravesLSTM, LSTM and GRU char-RNNs (rows 1, 3, 5) calibrated on
            one-hot rows, 8 clients of f32 and int8 rows: the dtypes
            coalesce apart, bit for bit, nothing captured on traffic; int8
            against f32 64-row p50 and host share. Plan slices: parallel_pipe's
            dense net under compose(data=2, pipe=4, microbatches=2) over 8 x
            cuda:0 fp32 (bit for bit ``net.output`` at the bucket, graphs =
            buckets x 2, the manifest replayed, refused flat and admitted
            sliced under a per-position budget of 0.6 of a copy); BERT-base
            under compose(data=2, tensor=2) over 4 x cuda:0 (<= 2e-2, 12
            flash launches per tensor piece a batch, 64-row p50).
            ``ParallelInference.builder(bert).workers(2)`` clamps to 1
            worker and answers bit for bit the registry.
12. http: (after ``residency``; ``--http`` runs the build and this phase only)
            serving's host side, each part a phase of its own. Worker: a
            ``ModelServer`` on 127.0.0.1 over BERT-base (2 replicas on
            cuda:0, warmed): 64-row requests over JSON (``"dtype":
            "int64"``, the warm-up example's) and over the binary wire, bit
            for bit ``registry.predict`` of the same rows, nothing captured
            on traffic, 12 flash launches a batch (counters and the
            profiler's kernel names); p50s of 20 sequential requests a
            protocol beside the in-process p50, bytes each way, and the host
            cost of printing and parsing the JSON. The GravesLSTM char-RNN
            at T=256: full-bucket requests over the binary wire bit for bit
            ``registry.predict`` with its launches, and one JSON request
            timed. Sessions over HTTP on the LSTM char-RNN: open, ``step``
            with step indices, a replay of the last step (same answer, carry
            not advanced), a 409 ``step_conflict``, then the rest of the
            stream over one connection as Server-Sent Events, every step bit
            for bit a serial ``rnn_time_step`` loop. Router over two
            in-process BERT-base workers: routed answers bit for bit the
            in-process answer whichever worker served, a straggler (chaos
            latency at ``serving.worker.predict``) hedged with one response
            a request and each duplicate counted, one worker stopped under 8
            concurrent clients with no client failure, restarted and
            readmitted with ``memory_allocated`` back within 1 MiB. Gated
            deploys of the GravesLSTM char-RNN through the router over an
            in-process fleet under client traffic: an equal candidate passes
            the gate and shadow and promotes through the ramped canary; a
            perturbed head fails a strict gate, and behind a lax one is
            caught in shadow and rolled back; no client error, the journal's
            ``delivery.stage`` sequences printed and checked.
13. fleet: (after ``http``; ``--fleet`` runs the build and this phase only)
            serving's host side, second half, each part a phase of its own,
            every worker straggling (seeded chaos latency on half its
            requests). Workers: a ``FleetSupervisor`` starts 2 BERT-base
            worker processes on cuda (bucket 64, one replica each; time to
            ready printed) behind a ``FleetRouter`` here: every answer bit
            for bit this process's ``registry.predict`` whichever worker
            served it, nothing captured on traffic, no kernel built in a
            worker. Drill: 8 closed-loop clients while the worker the
            traffic goes to is SIGKILLed (no client error, the relaunch's
            time to ready printed), then a rolling deploy to a v2 archive
            of the same weights under the same traffic. Control plane: 2
            router processes over one ``FleetConfig`` with lease-elected
            autoscalers behind a ``MultiRouterClient`` under 8 clients: the
            leader adds a replica on the worker the traffic goes to
            (captured before it takes traffic), the leader is SIGKILLed
            with no client error and the next decision comes from the new
            holder with a larger ``seq``; no router process maps the CUDA
            driver or opens a card's device file, where every worker does,
            and ``nvidia-smi`` counts this process and the workers only. Autoscale: the supervisor's ``SLOAutoscaler`` adds a
            worker process when the replicas are at the max (time to ready
            printed), its decision in ``/v1/autoscaler``. Scheduler: an
            in-process ``ModelServer`` with a ``Scheduler``: a fine-tune
            job (B=64, 20 steps) once uninterrupted (12 + 12 + 12 flash
            launches a step; a replica added while it runs) and once
            preempted by traffic and resumed, losses and final weights bit
            for bit; served answers bit for bit the idle ones; eval through
            the batcher equal to the direct predict; score; a sweep with
            the JAX package's trial sequence; a flywheel on BERT-base from
            256 labeled rows of token ids in a ``FeedbackLog`` (integer
            features) into a gated deploy over two BERT-base workers; the
            harvest's drop of ``device_idle_fraction``. No worker or router process outlives
            the phase; the workers' launch counts, written at their drain,
            join the kernels line.

Before the last line it prints one JSON object ``{"kernels": [...]}`` (one
row per kernel instance on a main path: the inference and saving forwards
and the backward of each LSTM cell and of the GRU, the inference and saving flash
forwards, the flash backward's dq and dk/dv kernels, whose plain and
library times are those of the whole backward, the dropout kernel's forward and
backward, the short-attention forward and backward in each layout, whose
backward is a pair of kernels counted as one launch, and conv_stats, whose
partial-sum and column-sum kernels are one launch)
and the card's name and power limit as ``nvidia-smi`` gives them; the last
line is ``{"ok": true, "device": {...}}``. With no CUDA
device, or without the rest of the repository beside it, it prints no
result and exits nonzero.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

SERVE_T, SERVE_B, HIDDEN, VOCAB, LAYERS = 256, 64, 512, 96, 2
# (T, B, H): the serving shape first, then the 1-row bucket, ragged widths, one
# step (rnn_time_step), and more rows than one launch takes; then the edges of
# the row-group kernels of both cells (bf16, H % 8 == 0): one whole row group
# of 16, a ragged one (17), three groups with a ragged third (33), the narrowest
# width (H = 8: one k tile, zero-padded), the backward's shared-memory edge
# (H = 1024: 8 units a block), and H = 100, whose bf16 rows are not whole
# 16-byte chunks (the CUDA-core kernels). H = 200 is a multiple of 8 and takes
# the row-group kernels, with a ragged unit group.
KERNEL_SHAPES = [(SERVE_T, SERVE_B, HIDDEN), (SERVE_T, 1, HIDDEN), (5, 3, 200),
                 (1, 64, 512), (3, 130, 64),
                 (8, 16, 512), (8, 17, 512), (8, 33, 512), (8, 5, 8), (8, 16, 1024), (5, 3, 100)]
# The recurrent kernels' names (the profiler's), by design: the row-group
# kernels for bf16 with H % 8 == 0 (and aligned operands, as every check's
# are), the CUDA-core kernels otherwise.
LSTM_ROW_GROUP = ("lstm_fwd_mma_kernel", "lstm_bwd_mma_kernel")
LSTM_CUDA_CORE = ("lstm_fwd_kernel", "lstm_bwd_kernel")
GRU_ROW_GROUP = ("gru_fwd_mma_kernel", "gru_bwd_mma_kernel")
GRU_CUDA_CORE = ("gru_fwd_kernel", "gru_bwd_kernel")
# The GRU's checks run at KERNEL_SHAPES and at two more edges of its
# row-group plan (bf16, H = 1024), each with the pair it must take: 32 rows
# take U = 16 in both kernels (2 x 64 blocks; the backward's 209 KB of
# shared memory, near the 227 KB a block may hold), and 64 rows have no plan
# (256 blocks at U = 16), so both take the CUDA-core kernels.
GRU_EDGE_SHAPES = {(8, 32, 1024): GRU_ROW_GROUP, (4, 64, 1024): GRU_CUDA_CORE}
RECURRENT_KERNEL = re.compile(r"((?:lstm|gru)_(?:fwd|bwd)(?:_mma)?_kernel)")
# Kernel vs plain version, max abs error over ys/hT/cT. float32: the two sum
# h @ W_rec in different orders. bfloat16: both round h to bf16 at every
# step, so a tie broken the other way by that order carries one bf16 ulp
# (0.0078 at |c| in [1, 2)) down the sequence; 4 ulps of headroom.
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 3.2e-2}
# Backward kernel vs plain version, max abs error over ds/dh0/dc0 divided by
# max(1, max |plain|): the dh carry grows along the reverse sequence, so the
# error is held relative to it. float32: summation order of ds @ W_rec^T.
# bfloat16: both round ds to bf16 at every step, so one rounding tie broken
# the other way carries a bf16 ulp (2^-8 relative) into dh; 8 ulps of headroom.
BWD_TOL = {"float32": 1e-4, "bfloat16": 3.2e-2}
# The autograd wrapper's float32 gradients vs torch.autograd of the plain
# forward, max abs error / max(1, max |plain|) per input: dW_rec and dpeep sum
# T*B products in another order on each side.
GRAD_TOL = 1e-3
# (cell, peepholes, mask) triples each kernel check runs
CELLS = (("fused_lstm", False, False), ("fused_graves_lstm", True, True),
         ("fused_graves_lstm", True, False))
# Shapes of the autograd check: the training shape, and two launches of rows
GRAD_SHAPES = [(SERVE_T, SERVE_B, HIDDEN), (3, 130, 64)]
# The char-RNNs the slice and train phases drive: cell -> log tag, the kernel
# wrapper its recurrent layers route to, and the offset of its seeds. "gru" is
# the same network as the zoo's with GRU cells, built with the builder DSL
# (the JAX package has no GRU zoo model).
CHAR_RNN_TAGS = {"graves": "graves=True", "lstm": "graves=False", "gru": "gru"}
CHAR_RNN_KERNELS = {"graves": "fused_graves_lstm", "lstm": "fused_lstm", "gru": "fused_gru"}
CHAR_RNN_SEEDS = {"graves": 1, "lstm": 0, "gru": 2}
# The kernels (profiler's names) a bf16 serving request and a training step of
# each char-RNN run: the forward's, and the backward's.
CHAR_RNN_RAN = {"graves": LSTM_ROW_GROUP, "lstm": LSTM_ROW_GROUP, "gru": GRU_ROW_GROUP}
# One Bidirectional(GRU) forward against the plain loop: (T, B, n_in), H = HIDDEN
BIDI_SHAPE = (64, 16, VOCAB)
# Served softmax probabilities vs the plain forward (bf16 compute).
SERVE_TOL = 1e-2
# rnn_time_step in 4 chunks vs the whole sequence: the chunks hand h/c over
# in bf16 where the whole sequence keeps c in fp32 inside the kernel.
CHUNK_TOL = 2e-2
CLIENTS, REQUESTS_PER_CLIENT = 8, 3
# Training: bench_char_rnn's shape (B=64, T=256 = one tBPTT chunk per batch),
# TRAIN_STEPS batches through fit; the first CMP_STEPS against the plain trainer.
TRAIN_B, TRAIN_T, TRAIN_STEPS, CMP_STEPS = 64, 256, 20, 3
# Per-step loss, kernels vs the plain trainer (the same network, optimizer and
# weights, with autograd through lstm_reference), max |difference| over the
# first CMP_STEPS steps. float32: summation order only. bfloat16: the two
# sides round differently placed values to bf16 (one-ulp differences in ys and
# ds), and RmsProp's first steps turn a near-zero gradient's sign into a full
# +-4.5e-3 weight step, so a few weights move apart.
TRAIN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# The mean loss of the last 3 steps must be below this share of the first
# step's (about ln 96 = 4.56 from random weights). The batches follow a seeded
# table of 4 successors per character, whose skewed character frequencies
# alone are worth about 3% of that; RmsProp at the zoo's 1e-3 learns them
# within TRAIN_STEPS steps, the successors themselves only later.
LOSS_FALL = 0.98
# Flash attention kernel checks: (b, h, t_q, t_k, d, d_v, key-padding mask,
# causal). BERT-base serving (with and without a mask that holds a length-1
# row and a fully masked row), the causal heads of
# examples/long_context_attention.py (12 x d=64) at T=4096, ragged lengths,
# cross attention, d_v != d, and the widest head the kernel takes; then d and
# d_v that are no multiple of 16 (d = 40, d_v = 20: rows that do not start on
# a 16-byte boundary, which the bf16 kernel stages element by element; d =
# 24, d_v = 40: padded with zeros to 32 and 48, staged by cp.async), and
# T=4096 causal with a key-padding mask (the causally skipped tiles and the
# bias together).
FLASH_SHAPES = [(64, 12, 128, 128, 64, 64, False, False), (64, 12, 128, 128, 64, 64, True, False),
                (1, 12, 4096, 4096, 64, 64, False, True), (3, 2, 77, 77, 64, 64, True, False),
                (3, 2, 77, 77, 64, 64, True, True), (2, 4, 100, 300, 32, 32, True, False),
                (2, 2, 256, 256, 128, 128, True, False), (2, 2, 256, 256, 128, 128, False, True),
                (2, 3, 33, 47, 48, 160, True, False), (2, 2, 70, 70, 256, 256, True, True),
                (3, 3, 65, 130, 40, 20, True, False), (2, 2, 50, 50, 24, 40, False, True),
                (1, 12, 4096, 4096, 64, 64, True, True)]
# The same checks, forward and backward, on views that start one element
# into their buffers (as check_dropout's offset): no row starts on a 16-byte
# boundary, so the bf16 kernels stage element by element.
FLASH_UNALIGNED = (3, 2, 77, 77, 64, 64, True, False)
# Flash kernel vs its plain version, max abs error of o and of lse. float32:
# summation order only (the online softmax rescales partial sums the dense
# softmax never forms). bfloat16: both round P to bf16 before P @ V, the
# kernel relative to the running max, the plain version relative to the
# final one, so a P value and then o can land one bf16 ulp apart (0.0078 at
# |o| in [1, 2)); 4 ulps of headroom. lse is fp32 on both sides from the same
# scores: summation order of up to 4096 terms of l.
FLASH_TOL = {"float32": (2e-5, 1e-3), "bfloat16": (3.2e-2, 1e-3)}
# The flash backward's long-context check: one head of T=16384 causal, the
# regime of the TPU's chunked backward (rows 9; T > 8192), which the same
# kernels take. Its plain version holds dense (T, T) fp32 matrices (~1 GB each).
FLASH_LONG_SHAPE = (1, 1, 16384, 16384, 64, 64, False, True)
# Backward kernels vs the plain backward on the same o, lse and dO, max abs
# error of dq, dk and dv divided by max |plain| of that gradient (no floor at
# 1: BERT's gradients are below 1). float32: summation order (up to 16384
# terms). bfloat16: the plain backward rounds dS and P at the kernel's points,
# so a value lands one bf16 ulp apart only where the tensor cores' sums (S in
# another order, P by ex2.approx) put a P or dS, or an fp32 sum, on the other
# side of a rounding tie. On an H100 (700 W) the tensor-core kernels read
# 0-2.7e-3 at the FLASH_SHAPES entries and 3.9e-3 at T=16384 (dk: one ulp of a
# value in [1, 2) against max |plain| 2.0), the same bits in every run. The
# limit is 2^-8: half a bf16 ulp of a value at the bottom of the largest
# gradient's binade, which a kernel that skipped the rounding of dS or P
# reaches wherever that moves a near-largest value by one ulp.
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -8}
# The autograd Function's float32 gradients vs torch.autograd of the plain
# forward, max abs error / max(1, max |plain|): summation order only (the
# shapes hold no fully masked row, whose flash gradient differs by design).
FLASH_GRAD_TOL = 1e-4
# Fused dropout (row 10): bench.py's verify_kernels shape (8192 x 768 bf16,
# rate 0.1) first, then ragged shapes, one element, and a 4k+3 tail. The
# kernel and its plain version draw the same Philox bits, so every check is
# bitwise, in float32 and bfloat16, with and without x, at every rate.
DROPOUT_SHAPES = [(8192, 768), (3, 130, 64), (1, 1), (4 * 1001 + 3,)]
DROPOUT_RATES = (0.1, 0.5, 0.0)
# The keep fraction of a mask must lie within this many binomial sigmas.
DROPOUT_SIGMAS = 5.0
# Short attention (rows 11-12): (b, h, t, d, key mask). BERT-base (with a
# mask holding a length-1 row and a fully masked row, and without), the
# longest t, t = 1, odd t, and d of 32, 64 and 128; then d = 24 at t = 17
# (padded to 32 with zeros, staged by cp.async), t = 129 with d = 33 (the
# bf16 forward's two passes, staged element by element) and d = 256 (two
# passes over 32-key tiles).
SHORT_SHAPES = [(64, 12, 128, 64, True), (64, 12, 128, 64, False), (2, 4, 512, 64, True),
                (3, 2, 1, 64, False), (3, 2, 77, 32, True), (2, 3, 77, 128, False),
                (2, 2, 512, 128, True), (3, 2, 17, 24, True), (2, 2, 129, 33, False),
                (3, 2, 100, 256, True)]
# The same checks on views one element into their buffers (element staging).
SHORT_UNALIGNED = (3, 2, 77, 64, True)
# Forward kernel vs its plain version, max abs error of o. float32: summation
# order only (d-term dots and the t-term row sum). bfloat16: both round P to
# bf16 before P @ V; the card's expf and the plain softmax's exp differ in the
# last fp32 bit, so a P near a rounding tie can round the other way and o
# move by one bf16 ulp (0.0078 at |o| in [1, 2)); 4 ulps of headroom.
SHORT_TOL = {"float32": 2e-5, "bfloat16": 3.2e-2}
# Backward kernels vs the plain backward, max abs error of dq, dk, dv over
# max |plain| of that gradient. float32: summation order. bfloat16: both round
# P and dS at the same points, so a value near a tie (as above) or an fp32
# sum in another order can move an output by one bf16 ulp: at most 2^-7 of a
# value in the largest gradient's binade, the limit.
SHORT_BWD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
# ShortAttentionFunction's float32 gradients vs torch.autograd of the plain
# forward, max abs error / max(1, max |plain|): summation order only.
SHORT_GRAD_TOL = 1e-4
# The ops phase: bench.py:572-626 (verify_kernels) through the entry points
# under autograd, bf16, against a dense fp32 softmax, with the bench's limits:
# forward max abs error <= 0.05, gradient <= 0.05 * max(max |g|, 1); dropout's
# zero fraction in (0.08, 0.12) at rate 0.1.
OPS_SHORT = (64, 12, 128, 64)
# The backward pair's time also at t = 512 (b, h, t, d), bf16 unmasked: the
# dq kernel's three passes over K/V tiles instead of the resident K and V.
SHORT_LONG = (8, 12, 512, 64)
OPS_FWD_TOL, OPS_GRAD_TOL, OPS_ZERO_FRAC = 0.05, 0.05, (0.08, 0.12)
# Empty launches (torch.cuda._sleep's spin_kernel) a profiler session makes
# before the first timed call and after the last, and leaves out of its
# counts: late in a long run, sessions lost some 8-10 kernel records each
# (0.6 of a pair's launches a call, or all of a short call's).
PROFILE_PAD_LAUNCHES = 32
# BERT-base serving: Bert.base() (L=12, H=768, A=12), bf16 compute over fp32
# weights, requests of 1-64 rows of T=128 token ids, as bench_zoo_bert.
BERT_T, BERT_B, BERT_LAYERS, BERT_VOCAB = 128, 64, 12, 30522
# Served class probabilities vs the forward built from the plain versions,
# and masked rows vs the same rows cut to their tokens: bf16 compute, where a
# one-ulp difference in an attention output (see FLASH_TOL) or in a product
# of another shape passes through 12 residual + LayerNorm layers into the
# pooler and the softmax.
BERT_TOL = 2e-2
# BERT-base fine-tuning: bench_zoo_bert's step (B=64, T=128, Adam(2e-5), bf16
# compute over fp32 weights, dropout 0.1 as the zoo sets it) through fit,
# BERT_TRAIN_STEPS seeded batches; the first BERT_CMP_STEPS against a trainer
# whose attention runs the plain forward and plain backward.
BERT_TRAIN_STEPS, BERT_CMP_STEPS = 20, 3
# The main path trains on bench_zoo_bert's data, random ids (whose labels it
# cannot learn), so that its step time is that workload's. A second fit from
# the same weights shows learning, on balanced labels with every token of a
# row its label's marker id (every_token). From random weights at lr 2e-5, 20
# steps learn no subtler rule of LABEL_RULES (``python3 chip_smoke.py
# --label-rules`` trains each): on an H100 (700 W) the others left the last 3
# losses at 0.65-0.74; every_token reached 0.604 and accuracy 1.0.
BERT_MARKERS = (1000, 2000)
# The loss falls in that fit: the mean of the last 3 steps must be below
# BERT_LOSS_FALL x the lower of the first step's loss and ln 2 = 0.693 (chance
# on balanced labels, and what learning the prior alone scores), and the
# trained net must label a fresh seeded batch with accuracy >= BERT_MIN_ACC
# (chance 0.5). Adam's first steps move each of the 110 M weights by about lr
# along its gradient's sign, which shifts every output by several logits, so
# steps 2-5 overshoot (to 3.2 on that run) before the loss settles; the first
# step alone is the baseline, not the mean of the first 3. That run: first
# 0.815, last 3 0.604.
BERT_LOSS_FALL, BERT_MIN_ACC = 0.95, 0.9
# Per-step loss, kernels vs the plain trainer (the same weights, batches and
# dropout masks: the masks are drawn on the card from the same RngManager
# stream), max |difference| over the first BERT_CMP_STEPS. float32: summation
# order only; Adam's first steps move a weight by about +-lr whatever its
# gradient's size, so gradients that are rounding noise (the key bias's) step
# apart by up to 2 lr, which moves the loss by far less than 1e-4. bfloat16:
# the two sides round differently placed values to bf16 (attention outputs
# one ulp apart, see FLASH_TOL), and those pass through 12 layers.
BERT_TRAIN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# samediff bert (BASELINE config #4 as bench.py:782-838 bench_imported_bert
# measures it): BERT-base built as the JAX package's TF import of its GraphDef
# yields it (imports/tf_oracles.build_bert_samediff, seed 0, vocab 30522),
# optimize()d, a 2-class head grafted, every weight made trainable, fit at
# B=64, T=128 under Adam(2e-5), bf16 compute over fp32 masters, over one epoch
# of SD_STEPS copies of bert_synthetic_batch(64, 128, 30522, seed=1) (the
# benchmark takes 48 per fit; 20 keep the phase short). The first
# BERT_CMP_STEPS losses in fp32 and bf16 against the same fit with the plain
# attention are held to BERT_TRAIN_TOL.
SD_HIDDEN, SD_HEADS, SD_FF, SD_STEPS = 768, 12, 3072, 20
# sd.output(feeds, "pooled_output") computes in the arrays' dtype, float32
# (no cast, as the JAX package's output), through 12 layers: the flash
# kernel's fp32 output sits within 2e-5 of its plain version (FLASH_TOL) and
# LayerNorm and the residuals carry that to the tanh pooler, whose values lie
# in (-1, 1).
SD_OUTPUT_TOL = 1e-4
# The learning check: a second fit from the same weights, on every_token's
# balanced labels (each row all its label's marker id, an all-ones mask),
# SD_STEPS steps at the main path's learning rate, 2e-5: the rule and the
# rate with which the zoo bert phase learns in 20 steps; the same
# BERT_LOSS_FALL and BERT_MIN_ACC limits.
SD_LEARN_LR = 2e-5
# tf import (BASELINE config #4 by the reference's route): the committed
# BERT-base GraphDef of tests/data (bench.py's build_bert_graphdef(batch=64,
# seq_len=128), its weight matrices stripped, tests/_torch_bert_fixture.py)
# refilled from bert_weights(seed=0), imported and optimize()d, then fit as the
# samediff bert phase fits: TF_STEPS steps under Adam(TF_LR), bf16 over fp32
# masters; the first TF_CMP_STEPS losses bit for bit the builder route's.
TF_FIXTURE = os.path.join(ROOT, "tests", "data", "bert_base_b64_t128.pb")
TF_FIXTURE_SIDECAR = os.path.join(ROOT, "tests", "data", "bert_base_b64_t128.json")
TF_STEPS, TF_CMP_STEPS, TF_LR = 20, 3, 2e-5
# solvers: the three line-search algorithms, fp32 with TF32 off, LeNet on the
# first SOLVER_LENET_BATCHES MNIST batches (the builder's defaults: 10
# iterations, a line search of 5 steps), and the char-RNNs at the train
# phase's widths (2x512, B=64, T=TRAIN_T) on SOLVER_RNN_BATCHES batches of
# SOLVER_RNN_ITERS iterations. The first batch on the card against the port's
# CPU run from the same archive, relative: LeNet's final loss; the
# char-RNNs' values through their first SOLVER_RNN_CPU_ITERS iterations (the
# CPU fits only those: at T=256 an evaluation costs it 2-8 s).
SOLVER_ALGOS = ("LBFGS", "CONJUGATE_GRADIENT", "LINE_GRADIENT_DESCENT")
SOLVER_LENET_BATCHES, SOLVER_RNN_BATCHES, SOLVER_RNN_ITERS = 5, 2, 4
SOLVER_CPU_TOL, SOLVER_RNN_CPU_ITERS = 1e-4, 1
# conv_stats (TPU row 13): row 13's own shape (s3b1_c1, s3b2_c1), one shape
# of each other ResNet-50 stage at batch 256 (s0b1_c3 at K = 64 is the widest
# M; s1b1_c1; s2b1_c3), the widest M at N = 64 (s0b1_c1: the wgmma kernel's
# narrowest tile), a ragged M at row 13's width and two ragged ones, each
# (M, K, N) in fp32 and bf16 with a nonzero shift. (37, 13, 5) is unaligned
# (K, N % 8 != 0) and takes conv_stats_kernel in bf16 too, as does the bf16
# x one element into its buffer (CONV_STATS_UNALIGNED). y is held to its plain version relative to max |plain
# y|: fp32, the same products summed in another order over K <= 2048 (1e-5);
# bf16, both sides round an fp32 sum to bf16, and two sums that straddle a
# rounding boundary land one bf16 ulp apart, 2^-8 of the value (2^-7). s1 and
# s2, fp32 sums over up to 802,816 rows in another order, relative to
# max(1, max |plain|): 1e-4. A second launch must agree bit for bit.
CONV_STATS_SHAPES = [(12544, 2048, 512), (802816, 64, 256), (200704, 512, 128),
                     (50176, 256, 1024), (802816, 256, 64), (12545, 2048, 512),
                     (1000, 200, 72), (37, 13, 5)]
CONV_STATS_UNALIGNED = (1000, 200, 72)
# The 15 distinct (M, K, N) of ResNet-50's 36 fused pairs at batch 256, 224x224
# (zoo/resnet50.py: stage s at (56 / 2^s)^2 x 256 rows), and launches a step.
RESNET_CONV_SHAPES = {
    (802816, 64, 64): 1, (802816, 64, 256): 4, (802816, 256, 64): 2,
    (200704, 256, 128): 1, (200704, 512, 128): 3, (200704, 128, 512): 4,
    (200704, 256, 512): 1, (50176, 512, 256): 1, (50176, 1024, 256): 5,
    (50176, 256, 1024): 6, (50176, 512, 1024): 1, (12544, 1024, 512): 1,
    (12544, 2048, 512): 2, (12544, 512, 2048): 3, (12544, 1024, 2048): 1}
CONV_STATS_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
CONV_STATS_SUM_TOL = 1e-4
# ResNet-50, BASELINE config #2 as bench.py:6736-6790 (bench_resnet) trains
# it: batch 256 of 224x224x3 bf16 images, 1000 classes, Nesterovs(0.1, 0.9),
# one synthetic batch repeated, RESNET_STEPS steps. Every plain 1x1
# convolution + BatchNormalization pair (36) runs through conv_stats in each
# training step. The losses of the first RESNET_CMP_STEPS steps against the
# same net whose pairs run conv_stats' plain version, each step from the
# kernel run's weights and statistics of that step (same batch): bf16 outputs
# one ulp apart pass through 53 normalizations, as BERT's through 12 layers
# (BERT_TRAIN_TOL), so the same 2e-2. Each step starts from the kernel run's
# weights because at lr 0.1 two trainers apart by rounding alone part fast: in
# a development run on the card, the same fp32 trainer run twice (cuDNN's
# algorithms are not deterministic in fp32) read 8.41969 and 8.38635 at step 3
# (batch 128), and the bf16 kernel and plain trainers, each deterministic,
# 6.37874 and 6.40024 after a first step 0.0039 apart. Served answers against the trained
# net's own output on the same 64 rows: the same program on the same card,
# probabilities within 1e-3.
RESNET_B, RESNET_HW, RESNET_CLASSES, RESNET_PAIRS = 256, 224, 1000, 36
RESNET_STEPS, RESNET_CMP_STEPS, RESNET_TOL = 20, 3, 2e-2
RESNET_SERVE_B, RESNET_SERVE_TOL = 64, 1e-3
# LeNet, BASELINE config #1: the zoo LeNet() at full width (28x28x1, conv 20
# and 50 5x5 same, dense 500, softmax 10, Adam(1e-3), seed 123), float32 with
# TF32 off, trained by fit for one epoch on MnistDataSetIterator(64,
# train=True): the dl4j-examples LeNetMNIST shape, 938 steps of the 60000
# synthetic images (the real IDX files are not in the repository). Test
# accuracy on the 10000 synthetic test images must reach LENET_MIN_ACC.
# PerformanceListener reports every LENET_PERF_FREQ iterations.
LENET_B, LENET_STEPS, LENET_MIN_ACC, LENET_PERF_FREQ = 64, 938, 0.95, 100
# The first LENET_CMP_STEPS losses on the card against the same net on the
# CPU from the same archive and batches, fp32: cuDNN and the CPU sum the
# convolutions' and products' terms in other orders, a few 1e-7 of a loss
# near 2.3; the same for 3 steps under each updater option of lenet_options.
LENET_CMP_STEPS, LENET_TOL = 3, 1e-4
# Served answers (8 clients x 3 requests of 1-64 rows of 784 floats) against
# net.output of the same rows on the card: the same program, in a bucket of
# another size; probabilities within 1e-4.
LENET_SERVE_TOL = 1e-4
# The runtime phase (the training runtime under every fit loop). Config #4 as
# bench_imported_bert runs it: one epoch of RUNTIME_SD_STEPS repeated
# batches, dispatch_unroll(RUNTIME_UNROLL) groups, one-step captured graphs
# and the eager step; each one's losses and final weights against the eager
# run's within RUNTIME_REL_TOL relative (to the largest |weight|), as the
# JAX package holds its unrolled SameDiff program (~1e-7). The zoo BERT
# with dropout 0.1 in RUNTIME_BERT_FITS fits of RUNTIME_UNROLL steps (one
# group each): every recorded mask's zero share within RUNTIME_DROP_BAND.
# ResNet-50 with prefetch_buffer=2 for RESNET_STEPS steps against
# prefetch_buffer=0 from one init: the same losses, bit for bit. A
# FaultTolerantTrainer on LeNet over RUNTIME_FT_BATCHES unshuffled batches,
# a checkpoint every RUNTIME_FT_EVERY iterations and a chaos fault at the
# RUNTIME_FT_FAULT-th fetch: its final weights against an uninterrupted
# run's within RUNTIME_REL_TOL. Early stopping on LeNet: at most
# RUNTIME_ES_EPOCHS epochs.
RUNTIME_SD_STEPS, RUNTIME_UNROLL, RUNTIME_REL_TOL = 48, 4, 1e-6
RUNTIME_BERT_FITS, RUNTIME_DROP_BAND = 5, (0.08, 0.12)
RUNTIME_FT_BATCHES, RUNTIME_FT_EVERY, RUNTIME_FT_FAULT = 30, 10, 17
RUNTIME_ES_EPOCHS = 3
# The parallel phase (config #5). ParallelWrapper on Bert.base() (dropout 0,
# Adam(2e-5), bf16 compute over fp32 weights) for PAR_STEPS steps of one
# bert_synthetic_batch(64, 128, 30522, seed=1), over a mesh that repeats
# cuda:0 PAR_WAYS times: data parallel, FSDP and tensor parallel, each beside
# its compose() twin (bit for bit), data parallel against the net's own fit
# (losses within BERT_TRAIN_TOL; weights within PAR_WEIGHT_TOL = 2 x steps x
# lr, the most Adam can move a weight apart in that many steps). The pipe
# plans on bench_parallel's net (5 x Dense(64, tanh) from 32 features -> 8,
# Sgd(0.05), PAR_PIPE_STEPS batches of 64) over 8 x cuda:0. The distributed
# trainer at bench_distributed's shape (PAR_DIST_* : 512 features, Dense 512
# relu -> 8, Sgd(0.1), local batch 256, world 2): loopback, then two
# processes over gloo computing on cuda:0, at threshold 0 and 1e-3; then
# world-2 loopback on Bert.base() at 1e-3 for PAR_DIST_BERT_STEPS steps.
# Ring attention over seq=4 x cuda:0 at PAR_RING_SHAPE bf16 against a dense
# fp32 softmax within PAR_RING_TOL (bench.py's attention limit).
PAR_WAYS, PAR_STEPS = 2, 10
PAR_WEIGHT_TOL = 2 * PAR_STEPS * 2e-5
PAR_PIPE_STEPS, PAR_PIPE_TOL = 12, dict(rtol=2e-5, atol=1e-6)
PAR_DIST_FEATURES, PAR_DIST_HIDDEN, PAR_DIST_LOCAL_B, PAR_DIST_STEPS = 512, 512, 256, 8
PAR_DIST_BERT_STEPS, PAR_DIST_MIN_RATIO = 3, 5.0
PAR_RING_SHAPE, PAR_RING_TOL = (1, 12, 4096, 64), 0.05

# The zoo phase. YOLO2 at the zoo's defaults (80 classes, 416x416x3, 5
# anchors, Nesterovs(1e-3, 0.9)), bf16 over fp32 weights, trained by fit at
# ZOO_YOLO_B on one synthetic detection batch for ZOO_YOLO_STEPS steps:
# ZOO_YOLO_PAIRS conv_stats launches a step; the first ZOO_CMP_STEPS losses
# against the plain conv_stats within ZOO_YOLO_TOL; served as 20 sequential
# ZOO_SERVE_B-row requests, each answer within ZOO_SERVE_TOL of the net's
# own output (relative to its largest magnitude: the raw predictions are not
# probabilities).
ZOO_YOLO_B, ZOO_YOLO_STEPS, ZOO_YOLO_PAIRS, ZOO_CMP_STEPS = 32, 20, 7, 3
ZOO_YOLO_TOL, ZOO_SERVE_B, ZOO_SERVE_TOL = 2e-2, 16, 1e-3
# Every other zoo CNN at its published input size: one forward and
# ZOO_CPU_STEPS training steps at batch ZOO_CPU_B in fp32 (TF32 off), card
# against the CPU from one archive within ZOO_CPU_TOL relative; forward ms
# at batch ZOO_FWD_B in bf16.
ZOO_CNNS = [("SimpleCNN", 48), ("AlexNet", 224), ("VGG16", 224), ("VGG19", 224),
            ("SqueezeNet", 224), ("Darknet19", 224), ("Xception", 299),
            ("InceptionResNetV1", 160), ("UNet", 128), ("TinyYOLO", 416)]
ZOO_CPU_B, ZOO_CPU_STEPS, ZOO_CPU_TOL, ZOO_FWD_B = 2, 2, 1e-3, 32
# The models whose first step crosses kinks (leaky ReLU or ReLU at 0, a
# max-pool's argmax) by float32 rounding alone, so that the second loss
# parts between the CPU's own two float32 convolution paths (oneDNN and the
# native one, from one archive on the same host): Darknet19 4.167416 vs
# 4.156012, Xception 0.074016 vs 0.073966, InceptionResNetV1 2.442764 vs
# 2.436626, where the others agree within 3.2e-5. For these alone a second
# loss beyond ZOO_CPU_TOL is judged against the CPU's float64 steps: the
# card no further from them than ZOO_KINK_FACTOR times the CPU float32's
# distance, plus ZOO_CPU_TOL (readings on the H100 box: the card 0.43-0.74
# of the CPU's).
# The output and the first loss are held at ZOO_CPU_TOL for every model.
ZOO_KINKED, ZOO_KINK_FACTOR = ("Darknet19", "Xception", "InceptionResNetV1"), 3
# Transfer learning: VGG16 (224, bf16) frozen up to its last hidden dense
# layer, a new 5-class head, ZOO_TL_STEPS steps at batch ZOO_TL_B.
ZOO_TL_B, ZOO_TL_HW, ZOO_TL_STEPS, ZOO_TL_CLASSES = 32, 224, 10, 5
# The graph char-RNN (config #3's 2x512 LSTM + RnnOutputLayer(96) as a
# ComputationGraph, bf16): rnn_time_step in chunks of ZOO_RNN_CHUNK over
# SERVE_T at SERVE_B rows; tBPTT fit of length ZOO_RNN_TBPTT for
# ZOO_RNN_WINDOWS windows at TRAIN_B, first ZOO_CMP_STEPS losses against the
# MultiLayerNetwork's (TRAIN_TOL in bf16).
ZOO_RNN_CHUNK, ZOO_RNN_TBPTT, ZOO_RNN_WINDOWS = 64, 64, 5
# Remat: ResNet-50 as the resnet phase trains it, ZOO_REMAT_STEPS steps with
# and without remat from the same weights; losses within ZOO_REMAT_TOL.
ZOO_REMAT_STEPS, ZOO_REMAT_TOL = 5, 2e-2

# serving (the device side of the served path): every model of the phase is
# served from SERVING_REPLICAS parameter copies on cuda:0 with SERVING_DEPTH
# batches in flight, warmed before traffic over the buckets 1-64 (one
# captured CUDA graph per bucket and replica); SERVING_SEQ sequential 64-row
# requests give the p50, SERVING_CONC = (clients, requests each) of 1-64 rows
# the concurrent samples/s, beside an A/B arm of the synchronous eager path
# (pipeline_depth 0, aot_dispatch off, one replica).
SERVING_REPLICAS, SERVING_DEPTH, SERVING_SEQ, SERVING_CONC = 2, 2, 20, (8, 4)
# Sessions over the LSTM char-RNN: SESSION_STREAMS concurrent streams of
# SESSION_STEPS steps of SESSION_T one-hot tokens, every step batch at the one
# session bucket SESSION_BUCKET; each stream bit for bit against a serial
# rnn_time_step loop padded to that bucket (the stream in row 0).
SESSION_BUCKET, SESSION_STREAMS, SESSION_STEPS, SESSION_T = 16, 16, 8, 32

# Serving's host side (phase http): HTTP_SEQ sequential requests a protocol
# for the p50s; HTTP_CLIENTS concurrent clients through the router while one
# worker stops; HTTP_HEDGED sequential requests whose first attempt the chaos
# point serving.worker.predict holds HTTP_STRAGGLE_S, with hedges after at
# least HTTP_HEDGE_MS; memory_allocated after a worker's restart within
# HTTP_MEM_SLACK of before its stop. The gated deploys serve the GravesLSTM
# char-RNN at bucket HTTP_DEPLOY_BUCKET from 2 one-replica workers under
# HTTP_DEPLOY_CLIENTS clients, the gate on HTTP_GOLDEN rows.
HTTP_SEQ, HTTP_CLIENTS, HTTP_HEDGED, HTTP_STRAGGLE_S, HTTP_HEDGE_MS = 20, 8, 4, 0.3, 50.0
HTTP_MEM_SLACK, HTTP_DEPLOY_BUCKET, HTTP_DEPLOY_CLIENTS, HTTP_GOLDEN = 2**20, 4, 3, 4
# Serving's host side, second half (phase fleet): FLEET_CLIENTS closed-loop
# clients in each drill; every worker straggles (FLEET_STRAGGLE: seeded
# chaos latency at serving.worker.predict on half the requests), so the
# routers' latency SLO (FLEET_SLO) burns and their lease-elected (lease
# FLEET_LEASE_S) autoscalers (FLEET_AUTOSCALER: one replica more at most)
# act; the fine-tune job runs FLEET_FT_STEPS steps, traffic arriving after
# FLEET_PREEMPT_AFTER of them; the sweep's trials for seed 7 are the JAX
# package's (SweepRun._trial_sequence, held equal on the CPU by
# tests/test_torch_serving_scheduler.py), on an 8-16-4 MLP, the sweep's own
# (build_net_from_spec). The flywheel fine-tunes the served BERT-base from
# FLEET_FLY_ROWS labeled feedback rows at T=128, FLEET_FLY_EPOCHS epochs.
FLEET_FLY_ROWS, FLEET_FLY_EPOCHS = 256, 2
FLEET_CLIENTS, FLEET_FT_STEPS, FLEET_PREEMPT_AFTER, FLEET_LEASE_S = 8, 20, 3, 1.0
FLEET_STRAGGLE = {"p": 0.5, "ms": 300.0, "seed": 25}
FLEET_SLO = {"availability": 0.999, "latency_ms": 250.0, "latency_target": 0.9}
FLEET_AUTOSCALER = dict(tick_s=0.25, fast_window_s=10, slow_window_s=60, up_burn=2.0,
                        confirm_burn=1.0, down_burn=0.5, up_cooldown_s=3.0,
                        down_cooldown_s=3600.0, min_requests=8, max_replicas=2,
                        predictive=False, lever_timeout_s=120.0)
FLEET_SWEEP_SPACE = {"lr": [0.05, 0.2], "hidden": [[16], [32]], "activation": ["tanh", "relu"]}
FLEET_SWEEP_TRIALS = [{"activation": "relu", "hidden": [16], "lr": 0.2},
                      {"activation": "tanh", "hidden": [16], "lr": 0.05},
                      {"activation": "relu", "hidden": [16], "lr": 0.05},
                      {"activation": "tanh", "hidden": [16], "lr": 0.2}]
FLASH_FWD_KERNEL = re.compile(r"(flash_fwd(?:_mma)?_kernel)")

# Serving's device side, second half (phase residency). Paging: four BERT-base
# names (two seeds, each twice) registered cold under a budget of
# RESIDENCY_BUDGET_MODELS x one model's measured ledger bytes (the JAX drill's
# rule, bench.py:3270), 1 replica each at RESIDENCY_BUCKETS; RESIDENCY_CLIENTS
# threads x RESIDENCY_REQUESTS requests of 1-64 rows rotating over the names;
# RESIDENCY_CYCLES evict/page-in cycles of one model, memory_allocated after
# the last eviction within RESIDENCY_LEAK of the first. Quantized deploys:
# the gate on RESIDENCY_GOLDEN golden rows.
RESIDENCY_SEED, RESIDENCY_BUCKETS, RESIDENCY_BUDGET_MODELS = 321, (1, 8, 64), 2.5
RESIDENCY_CLIENTS, RESIDENCY_REQUESTS, RESIDENCY_CYCLES = 3, 8, 5
RESIDENCY_LEAK, RESIDENCY_GOLDEN = 16 * 2**20, 256
# The pipe drill at microbatches 2 runs the trunk on half the rows, where
# cuBLAS may order a row's fp32 sums otherwise than at the bucket's rows
# (1.19e-7 in the first run): its probabilities against net.output's.
PIPE_MB_TOL = 1e-6

# The distributed trainer's worker, one process per rank, both on cuda:0:
# argv rank world port threshold steps local_batch features hidden.
DIST_WORKER = r"""
import hashlib, json, os, sys, time
import numpy as np

rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
threshold, steps, local_b = float(sys.argv[4]), int(sys.argv[5]), int(sys.argv[6])
features, hidden = int(sys.argv[7]), int(sys.argv[8])

import torch
from deeplearning4j_tpu_torch.runtime.environment import get_environment
get_environment().set_device("cuda:0").set_compute_dtype("float32")
torch.backends.cuda.matmul.allow_tf32 = False
from deeplearning4j_tpu_torch.runtime.mesh import initialize_multihost
initialize_multihost(f"127.0.0.1:{port}", world, rank)
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import DenseLayer, InputType, NeuralNetConfiguration, OutputLayer
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
from deeplearning4j_tpu_torch.train import Sgd
from deeplearning4j_tpu_torch.train.distributed import DistributedConfig, DistributedTrainer

conf = (NeuralNetConfiguration.builder().seed(7).updater(Sgd(0.1)).list()
        .layer(DenseLayer(n_out=hidden, activation="relu"))
        .layer(OutputLayer(n_out=8, activation="softmax"))
        .set_input_type(InputType.feed_forward(features)).build())
try:
    net = MultiLayerNetwork(conf).init()
    tr = DistributedTrainer(net, DistributedConfig(threshold=threshold))
    B = world * local_b
    t0 = None
    for i in range(steps + 2):
        if i == 2:  # after the eager warm-up step and the capture
            torch.cuda.synchronize()
            tr.reset_stats()
            t0 = time.perf_counter()
        brng = np.random.default_rng(1000 + i)
        x = brng.normal(0, 1, (B, features)).astype(np.float32)
        y = np.eye(8, dtype=np.float32)[brng.integers(0, 8, B)]
        tr.step(x, y)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
except BaseException as e:  # noqa: BLE001
    print(f"WORKER-FAILED {type(e).__name__}: {e}", flush=True)
    os._exit(17)  # the peer sees an exit code, not a stalled collective
h = hashlib.sha256()
for t in tree_leaves(net.params()):
    h.update(t.detach().cpu().numpy().tobytes())
rep = tr.stats.report()
print("RES" + json.dumps({"losses": tr.losses, "phash": h.hexdigest(),
                          "steps_per_sec": steps / elapsed, "report": rep}), flush=True)
os._exit(0)
"""

# Published peaks of one H100 SXM (dense): bf16 tensor cores, fp32 without
# tensor cores, memory rate.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps, warmup=2):
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps, warmup=2):
    """Mean device milliseconds per call of ``fn`` by CUDA events, with the
    card held by a spin kernel (``torch.cuda._sleep``) while the host queues
    the ``reps`` calls: calls whose host time outlasts their device time
    then still run back to back on the card. The gaps between launches are
    in it, the host's launch time is not (unless ``fn`` waits for the
    card). The spin lasts at least twice the host time of the calls (from
    the warm-up, at most 2 GHz)."""
    import torch
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / max(warmup, 1)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6 * (2 * reps * host_ms + 1)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def char_rnn_conf(cell, tbptt_length):
    """The 2x512 char-RNN of ``cell``: ``TextGenerationLSTM(vocab 96,
    hidden 512, 2 layers)`` for the LSTM cells, and for "gru" the same
    network built with the builder DSL as ``zoo/textgen_lstm.py`` builds it,
    GRU cells in place of the LSTMs (RmsProp(1e-3), seed 123)."""
    from deeplearning4j_tpu_torch.nn import (GRU, InputType, NeuralNetConfiguration,
                                             RnnOutputLayer)
    from deeplearning4j_tpu_torch.train.updaters import RmsProp
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    if cell != "gru":
        return TextGenerationLSTM(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS,
                                  tbptt_length=tbptt_length, graves=cell == "graves").conf()
    b = NeuralNetConfiguration.builder().seed(123).updater(RmsProp(1e-3)).list()
    for _ in range(LAYERS):
        b.layer(GRU(n_out=HIDDEN, activation="tanh"))
    return (b.layer(RnnOutputLayer(n_out=VOCAB, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.recurrent(VOCAB))
            .tbptt_fwd_length(tbptt_length).tbptt_back_length(tbptt_length).build())


def aot_replays():
    """CUDA graph replays of every ``AotCache`` so far."""
    from deeplearning4j_tpu_torch.runtime import compile_cache
    return compile_cache.stats()["aot_replays"]


def all_counters():
    """Every kernel wrapper's launch counter."""
    from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.ops.kernels import fused_attention_short as sa
    from deeplearning4j_tpu_torch.ops.kernels import (conv_stats, fused_dropout, fused_gru,
                                                      fused_lstm, fused_lstm_graves)
    return [c for m in (fused_lstm, fused_lstm_graves, fused_gru)
            for c in (m.counter, m.save_counter, m.bwd_counter)] + \
        [fa.counter, fa.lse_counter, fa.bwd_dq_counter, fa.bwd_dkv_counter,
         fused_dropout.counter, fused_dropout.bwd_counter,
         sa.counter, sa.bwd_counter, sa.btd_counter, sa.btd_bwd_counter, conv_stats.counter]


def gru_inputs(T, B, H, dtype, device, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    a = {"zx": torch.randn(T, B, 3 * H, generator=g),
         "w_rec": torch.randn(H, 3 * H, generator=g) * (1.0 / H) ** 0.5,
         "h0": torch.randn(B, H, generator=g) * 0.5}
    return {k: v.to(dtype).to(device).contiguous() for k, v in a.items()}


def lstm_inputs(T, B, H, dtype, device, seed, peep, mask):
    import torch
    g = torch.Generator().manual_seed(seed)
    a = {"zx": torch.randn(T, B, 4 * H, generator=g),
         "w_rec": torch.randn(H, 4 * H, generator=g) * (1.0 / H) ** 0.5,
         "peep": torch.randn(3 * H, generator=g) * 0.3 if peep else None,
         "h0": torch.randn(B, H, generator=g) * 0.5,
         "c0": torch.randn(B, H, generator=g)}
    if mask:
        m = (torch.rand(T, B, generator=g) > 0.25).float()
        m[:, 0] = 0.0  # a row with every step masked
        if B > 2:
            m[:, B // 2] = 0.0
        a["mask"] = m
    else:
        a["mask"] = None
    return {k: None if v is None else v.to(dtype).to(device).contiguous()
            for k, v in a.items()}


def flash_inputs(b, h, t_q, t_k, d, d_v, dtype, device, seed, mask):
    """q, k, v in the JAX layout and, with ``mask``, a key-padding mask of
    random lengths (with 3 rows or more: row 0 attends one key, row 1
    none)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    q, k = (torch.randn(b, h, t, d, generator=g) for t in (t_q, t_k))
    v = torch.randn(b, h, t_k, d_v, generator=g)
    m = None
    if mask:
        lengths = torch.randint(1, t_k + 1, (b,), generator=g)
        if b >= 3:
            lengths[0], lengths[1] = 1, 0
        m = (torch.arange(t_k)[None, :] < lengths[:, None]).to(device)
    return [t.to(dtype).to(device) for t in (q, k, v)], m


def shifted(x, offset):
    """A copy of ``x`` that starts ``offset`` elements into its buffer (so
    that, for offset 1, no row starts on a 16-byte boundary)."""
    import torch
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    buf[offset:].copy_(x.reshape(-1))
    return buf[offset:].view(x.shape)


def stage_tag(module, tensors, offset=0):
    """How a bf16 tensor-core kernel stages these operands (the outputs
    the launcher allocates are aligned): by cp.async or element by
    element; with the view's offset."""
    how = "cp.async" if module._vector_ok(*tensors) else "element"
    return f"stage={how}" + (f" offset={offset}" if offset else "")


def btd_views(tensors, heads):
    """``(b, h, t, d)`` tensors copied into ``(b, t, h*d)`` layout, and the
    ``(b, h, t, d)`` views of those copies that short_attention_btd hands the
    kernels."""
    b, h, t, d = tensors[0].shape
    flat = [x.transpose(1, 2).reshape(b, t, h * d).contiguous() for x in tensors]
    return flat, [x.view(b, t, heads, d).transpose(1, 2) for x in flat]


def bits_equal(a, b):
    """Bitwise equality of two float tensors (so -0.0 differs from +0.0)."""
    import torch
    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(a.view(as_int[a.dtype]), b.view(as_int[b.dtype]))


def arrays_equal(a, b):
    """Bitwise equality of two numpy arrays (so -0.0 differs from +0.0)."""
    import numpy as np
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.view(np.uint8).tobytes() == b.view(np.uint8).tobytes()


def http_json(pool, address, name, x, dtype=True):
    """One JSON predict of ``x`` (``"dtype"`` declared unless ``dtype`` is
    false): ``(status, outputs as float32 or None, headers, bytes sent,
    bytes received)``."""
    import numpy as np
    body = {"inputs": x.tolist()}
    if dtype:
        body["dtype"] = str(x.dtype)
    raw = json.dumps(body).encode()
    status, headers, data = pool.request(address, "POST", f"/v1/models/{name}/predict", body=raw,
                                         headers={"Content-Type": "application/json"},
                                         timeout=120)
    out = np.asarray(json.loads(data)["outputs"], np.float32) if status == 200 else None
    return status, out, headers, len(raw), len(data)


def http_wire(pool, address, name, x):
    """One binary-wire predict of ``x``: as :func:`http_json`."""
    import numpy as np
    from deeplearning4j_tpu_torch.serving import wire
    frame = wire.encode_predict_request(x)
    status, headers, data = pool.request(address, "POST", f"/v1/models/{name}/predict",
                                         body=frame, headers={"Content-Type": wire.CONTENT_TYPE},
                                         timeout=120)
    out = None
    if status == 200:
        _, _, view, fr = wire.decode_predict_response(data)
        out = np.array(view)
        view = None
        fr.close()
    return status, out, headers, len(frame), len(data)


def http_post(address, path, body, timeout=120):
    """One JSON POST over a fresh connection: ``(status, headers, body
    bytes)``; an HTTP error is returned, not raised."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://{address}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def p50_ms(fn, n):
    """Median wall milliseconds of ``n`` sequential calls of ``fn``."""
    import numpy as np
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ms.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(ms))


def wait_for(pred, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def http_text(address, path, timeout=30):
    """The body of one GET as text."""
    import urllib.request
    with urllib.request.urlopen(f"http://{address}{path}", timeout=timeout) as resp:
        return resp.read().decode()


def http_json_get(address, path, timeout=30):
    """The JSON body of one GET."""
    return json.loads(http_text(address, path, timeout))


def metric(text, name):
    """The value of an unlabelled Prometheus line ``name value``, or None."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return None


def card_marks(pid):
    """What ties process ``pid`` to the card, read from ``/proc``: ``libcuda``
    when it maps the CUDA driver, and each ``/dev/nvidia*`` file it holds
    open (a context holds its card's ``/dev/nvidia<N>``)."""
    marks = set()
    try:
        with open(f"/proc/{pid}/maps") as f:
            if any("libcuda.so" in line for line in f):
                marks.add("libcuda")
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if target.startswith("/dev/nvidia"):
                marks.add(target)
    except OSError as e:
        marks.add(f"unreadable: {e}")
    return sorted(marks)


def nvidia_smi_apps():
    """``(pid, used_memory)`` of each process holding the card, as
    ``nvidia-smi --query-compute-apps=pid,used_memory --format=csv,noheader``
    lists them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    apps = []
    for line in out.strip().splitlines():
        pid, _, mem = line.partition(",")
        if pid.strip().isdigit():
            apps.append((int(pid), mem.strip()))
    return apps


class InProcFleet:
    """In-process ``ModelServer`` workers behind a ``FleetRouter``, with what
    a rolling or gated deploy asks of a fleet: ``endpoints``, ``worker_ids``,
    ``worker_archive`` and ``restart_worker`` (which stops the worker and
    builds it again from the archive on a new port, as
    ``tests/test_delivery.py``'s ``_InProcFleet``). ``launch(wid, archive,
    version)`` returns a started server."""

    def __init__(self, launch):
        self._launch = launch
        self._lock = threading.Lock()
        self._workers = {}
        self.restarts = []

    def add(self, wid, archive, version=1, server=None):
        server = server or self._launch(wid, archive, version)
        with self._lock:
            self._workers[wid] = {"server": server, "archive": archive,
                                  "address": f"127.0.0.1:{server.port}"}
        return server

    def endpoints(self):
        with self._lock:
            return {w: s["address"] for w, s in self._workers.items()}

    def worker_ids(self):
        with self._lock:
            return list(self._workers)

    def worker_archive(self, wid):
        with self._lock:
            return self._workers[wid]["archive"]

    def stop_worker(self, wid):
        with self._lock:
            w = self._workers[wid]
            server, w["server"] = w["server"], None
        if server is not None:
            server.stop(shutdown_registry=True)

    def restart_worker(self, wid, archive=None, version=None):
        self.stop_worker(wid)
        self.restarts.append((wid, archive))
        self.add(wid, archive or self.worker_archive(wid), version)

    def stop(self):
        for wid in self.worker_ids():
            self.stop_worker(wid)


class Clients:
    """``n`` closed-loop client threads calling ``ask(c, k)`` until stopped:
    every outcome recorded as ``(client, k, status, answer)``."""

    def __init__(self, n, ask):
        self.ask = ask
        self.outcomes = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.threads = [threading.Thread(target=self._run, args=(c,), name=f"smoke-http-{c}",
                                         daemon=True) for c in range(n)]

    def _run(self, c):
        k = 0
        while not self._stop.is_set():
            try:
                status, out = self.ask(c, k)
            except Exception as e:  # a client-visible failure
                status, out = f"{type(e).__name__}: {e}", None
            with self._lock:
                self.outcomes.append((c, k, status, out))
            k += 1

    def __enter__(self):
        for t in self.threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self.threads:
            t.join(timeout=120)
        if any(t.is_alive() for t in self.threads):
            self.outcomes.append((None, None, "a client thread hung", None))


def attention_pairs(b, h, t_q, t_k, mask, causal):
    """(query, key) pairs the function needs on these inputs: the keys a
    row attends (every key for a fully masked row, whose answer is the mean
    of V), or those on and below the diagonal when causal (not both)."""
    if mask is not None and causal:
        raise ValueError("attention_pairs counts a mask or the causal triangle, not both")
    per_row = t_q * (t_q + 1) // 2 if causal else t_q * t_k
    if mask is None:
        return b * h * per_row
    keys = mask.sum(dim=1).tolist()
    return h * sum(t_q * (n if n else t_k) for n in keys)


def max_err(got, want, relative=False):
    """Max abs difference over paired tensors; ``relative`` divides it by
    max(1, max |want|)."""
    err = max(float((x.float() - y.float()).abs().max()) for x, y in zip(got, want))
    if not relative:
        return err
    return err / max(1.0, max(float(y.float().abs().max()) for y in want))


def bound(tensors, flops, dtype):
    """Least time the card could take: each input read once and each output
    written once at the memory rate, vs ``flops`` (the recurrent product) at
    the peak rate of ``dtype``. Returns (ms, 'bytes'|'operations')."""
    moved = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    rate = PEAK_FLOPS[str(dtype).replace("torch.", "")]
    t_bytes, t_ops = moved / PEAK_BYTES * 1e3, flops / rate * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def char_batches(n, seed):
    """``n`` one-hot (x, y) batches of next-character prediction, B=TRAIN_B,
    T=TRAIN_T: sequences drawn from a seeded table that gives each of the
    VOCAB characters 4 possible successors."""
    import numpy as np
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, VOCAB, (VOCAB, 4))
    eye = np.eye(VOCAB, dtype=np.float32)
    out = []
    for _ in range(n):
        ids = np.empty((TRAIN_B, TRAIN_T + 1), np.int64)
        ids[:, 0] = rng.integers(0, VOCAB, TRAIN_B)
        pick = rng.integers(0, 4, (TRAIN_B, TRAIN_T))
        for t in range(TRAIN_T):
            ids[:, t + 1] = succ[ids[:, t], pick[:, t]]
        out.append((eye[ids[:, :-1]], eye[ids[:, 1:]]))
    return out


def yolo2_conf(zoo):
    """The zoo YOLO2's configuration with the gradients renormalized to unit
    L2 per layer and parameter type (``RenormalizeL2PerLayer``, as the
    reference's own YOLO2 trains): under the zoo's Nesterovs(1e-3, 0.9)
    alone the summed detection loss diverges within a few steps (444 to NaN
    by step 6 in float32 at batch 4), in either package."""
    conf = zoo.conf()
    conf.global_conf.gradient_normalization = "RenormalizeL2PerLayer"
    conf.global_conf.gradient_normalization_threshold = 1.0
    return conf


def clone_tree(tree):
    from deeplearning4j_tpu_torch.runtime.trees import tree_map
    return tree_map(lambda t: t.detach().clone(), tree)


def label_batches(n, seed, rule, prior=0.5, repeat=False):
    """``n`` (token ids, one-hot labels) batches of BERT_B rows of BERT_T
    ids: a row's label is 1 with probability ``prior``; ``rule(rng, m)``
    makes the ids from the rows' markers ``m`` (BERT_MARKERS[label]).
    ``repeat``: ``n`` copies of one batch."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(1 if repeat else n):
        label = (rng.random(BERT_B) < prior).astype(np.int64)
        ids = rule(rng, np.asarray(BERT_MARKERS)[label][:, None])
        out.append((ids, np.eye(2, dtype=np.float32)[label]))
    return out * n if repeat else out


def marked(positions):
    """Random ids with the row's marker in its first ``positions`` tokens."""
    def rule(rng, m):
        import numpy as np
        ids = rng.integers(0, BERT_VOCAB, (BERT_B, BERT_T))
        ids[:, :positions] = m
        return ids
    return rule


def bag(k):
    """Every token one of ``k`` ids that belong to the row's label."""
    return lambda rng, m: m + rng.integers(0, k, (BERT_B, BERT_T))


def every_token(rng, m):
    """Every token the row's marker: the rule bert_train_phase trains on."""
    return m.repeat(BERT_T, axis=1)


# --label-rules: (name, rule, prior, one batch repeated)
LABEL_RULES = [("marker in token 0, 3:1", marked(1), 0.75, False),
               ("marker in token 0", marked(1), 0.5, False),
               ("marker in token 0, one batch repeated", marked(1), 0.5, True),
               ("marker in tokens 0-15", marked(16), 0.5, False),
               ("marker in tokens 0-63", marked(64), 0.5, False),
               ("every token from 64 label ids", bag(64), 0.5, False),
               ("every token from 8 label ids", bag(8), 0.5, False),
               ("every token the marker", every_token, 0.5, False)]


def random_ids(rng, m):
    """bench_zoo_bert's data: random ids; the label is not in them."""
    return rng.integers(0, BERT_VOCAB, (BERT_B, BERT_T))


class StepStamps:
    """A listener that records the host clock when each iteration is done;
    it reads the loss first, which waits for the device."""

    def __init__(self, stamps):
        self.stamps = stamps

    def iteration_done(self, model, iteration, epoch, score):
        float(score)
        self.stamps.append(time.perf_counter())

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        pass


class DoneStamps(StepStamps):
    """StepStamps that reads no model state: ``fit`` keeps its state packed
    and delivers to it from the completion thread, where reading the loss
    waits for that step alone."""

    needs_model_state = False


class plain_recurrences:
    """Within the block the recurrent layers run the plain forward under
    autograd (``lstm_reference``, ``gru_reference``) in place of the
    kernels' wrappers: the forward and the trainer built from the plain
    versions, for comparison only."""

    def __enter__(self):
        from deeplearning4j_tpu_torch.nn import recurrent_layers as rl
        from deeplearning4j_tpu_torch.ops.kernels.fused_gru import gru_reference
        from deeplearning4j_tpu_torch.ops.kernels.fused_lstm import lstm_reference
        self.rl, self.saved = rl, (rl.fused_lstm, rl.fused_graves_lstm, rl.fused_gru)
        rl.fused_lstm = lambda zx, w, h0, c0: lstm_reference(zx, w, None, h0, c0, None)
        rl.fused_graves_lstm = lambda zx, w, p, h0, c0, m=None: lstm_reference(
            zx, w, p, h0, c0, m)
        rl.fused_gru = gru_reference
        return self

    def __exit__(self, *exc):
        self.rl.fused_lstm, self.rl.fused_graves_lstm, self.rl.fused_gru = self.saved
        return False


def plain_flash_function():
    """An autograd Function over the flash kernel's plain versions:
    ``flash_attention_reference`` forward, ``flash_attention_backward_reference``
    backward (what the kernels compute, with the same lse and rounding
    points)."""
    import torch
    from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, mask, causal):
            o, lse = fa.flash_attention_reference(q, k, v, mask, causal)
            ctx.save_for_backward(q, k, v, o, lse, mask)
            ctx.causal = causal
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse, mask = ctx.saved_tensors
            grads = fa.flash_attention_backward_reference(q, k, v, o, lse, do, mask, ctx.causal)
            return (*grads, None, None)

    return PlainFlash


class plain_attention:
    """Within the block every attention layer runs the flash kernel's plain
    versions in place of the kernels' wrapper: ``flash_attention_reference``
    for the forward and, where autograd records, its plain backward. The
    forward and the trainer built from the plain versions, for comparison
    only."""

    def __enter__(self):
        import torch
        from deeplearning4j_tpu_torch.nn import attention_layers as al
        from deeplearning4j_tpu_torch.ops.kernels.flash_attention import \
            flash_attention_reference
        plain = plain_flash_function()

        def attention(q, k, v, mask=None, causal=False):
            if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
                return plain.apply(q, k, v, mask, causal)
            return flash_attention_reference(q, k, v, mask, causal)[0]

        self.al, self.saved = al, al.flash_attention
        al.flash_attention = attention
        return self

    def __exit__(self, *exc):
        self.al.flash_attention = self.saved
        return False


class plain_conv_stats:
    """Within the block conv_stats runs its plain version on the card in
    place of the kernel (the same autograd Function, the same backward): the
    trainer built from the plain version, for comparison only."""

    def __enter__(self):
        from deeplearning4j_tpu_torch.ops.kernels import conv_stats as cs
        self.cs, self.saved = cs, cs.launch_conv_stats
        cs.launch_conv_stats = lambda x2d, w, shift, launches=None: \
            cs.conv_stats_reference(x2d, w, shift)
        return self

    def __exit__(self, *exc):
        self.cs.launch_conv_stats = self.saved
        return False


class Smoke:
    def __init__(self, device):
        import torch
        self.torch = torch
        self.device = device
        self.failures = []
        self.kernels = {}  # name -> JSON row
        self.train_step_ms = {}  # cell -> median step ms of the train phase
        self.serve_p50_ms = {}  # cell -> p50 of one 64-row request
        self.bert_train_step_ms = None  # median step ms of the bert train phase
        self.flash_lse_ms = None  # the saving forward at BERT-base's shape, masked
        self.bert_p50_ms = None  # one 64-row BERT-base request, p50
        self.resnet_step_ms = None  # median step ms of the resnet phase
        self.resnet_conv_stats_ms = None  # conv_stats' device ms in one resnet step
        self.card = ""  # nvidia-smi's name and power limit, beside every number

    def check(self, ok, what):
        log(("ok   " if ok else "FAIL ") + what)
        if not ok:
            self.failures.append(what)

    def add_launches(self, counts):
        """Add a main path's launch counts to the kernels' rows (each phase
        reads its own counts and adds them here)."""
        for name, n in counts.items():
            if n or name in self.kernels:
                row = self.kernels.setdefault(name, {})
                row["launches"] = row.get("launches", 0) + n

    # ------------------------------------------------------------ phases
    def phase(self, name, fn):
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # record, keep going, fail at the end
            import traceback
            traceback.print_exc()
            self.failures.append(f"{name}: {type(e).__name__}: {e}")
        log(f"== {name} took {time.perf_counter() - t0:.1f} s")

    def build(self):
        from deeplearning4j_tpu_torch.ops.kernels import (  # noqa: F401
            _native, conv_stats, flash_attention, fused_attention_short, fused_dropout, fused_gru,
            fused_lstm)
        t0 = time.perf_counter()
        seconds = _native.build_all()
        log(f"kernel build: {time.perf_counter() - t0:.2f} s wall; per source {seconds}")
        for lib in _native._LIBRARIES.values():
            kernel = ""
            for line in lib.build_log.splitlines():
                if "Compiling entry function" in line:
                    kernel = line.split("'")[1] if "'" in line else line
                    # lstm_fwd_kernel<T, PEEP, MASK, SAVE>, gru_fwd_kernel<T, SAVE>,
                    # flash_fwd_mma_kernel<DMAX, CAUSAL, VEC> or
                    # flash_bwd_dq_kernel_mma<DMAX, CAUSAL, VEC> from its mangled name
                    # (dropout_kernel<T> and conv_stats_kernel<T> have no flag,
                    # flash_fwd_kernel<DMAX, CAUSAL, SAVE> no type)
                    m = re.search(r"\d+([a-z_]+_kernel(?:_mma)?)I\d*(\w*?)((?:L[ib]\d+E)*)E",
                                  kernel)
                    if m:
                        args = ([m[2]] if m[2] else []) + re.findall(r"L[ib](\d+)E", m[3])
                        kernel = f"{m[1]}<{', '.join(args)}>"
                    else:  # no template: gru_bwd_mma_kernel
                        m = re.search(r"\d+([a-z_]+_kernel)E", kernel)
                        kernel = m[1] if m else kernel
                elif "Used" in line and "registers" in line:
                    log(f"  {lib.source.name} {kernel}: {line.split(':', 1)[1].strip()}")
                elif "spill" in line and " 0 bytes spill stores" not in line:
                    log(f"  {lib.source.name} {kernel}: {line.split(':', 1)[-1].strip()}")
                    if kernel.startswith("conv_stats_wgmma_kernel"):
                        self.check(False, f"{kernel} spills (a spilling instance does not ship)")
        self.count_hgmma(conv_stats.LIBRARY)

    def count_hgmma(self, lib):
        """``HGMMA`` (wgmma) instructions per kernel of a built library, by
        ``cuobjdump -sass``: each ``conv_stats_wgmma_kernel`` instance must
        hold some."""
        from deeplearning4j_tpu_torch.ops.kernels import _native
        cuobjdump = os.path.join(os.path.dirname(_native._nvcc()), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", str(lib._target())], capture_output=True,
                              text=True, timeout=120).stdout
        counts, kernel = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                m = re.search(r"\d+([a-z_]+_kernel)I\w*?((?:Li\d+E)*)E", line)
                kernel = None
                if m:
                    args = re.findall(r"Li(\d+)E", m[2])
                    kernel = f"{m[1]}<{', '.join(args)}>"
                if kernel and kernel.startswith("conv_stats_wgmma_kernel"):
                    counts[kernel] = 0
            elif "HGMMA" in line and kernel in counts:
                counts[kernel] += 1
        log(f"  {lib.source.name} HGMMA instructions (cuobjdump -sass): {counts}")
        self.check(len(counts) == 3 and all(counts.values()),
                   f"conv_stats_wgmma_kernel<64|128|256> each hold HGMMA: {counts}")

    def kernel_phase(self):
        self.recurrent_checks()
        self.flash_checks()
        self.dropout_checks()
        self.short_attention_checks()
        self.conv_stats_checks()

    def recurrent_checks(self):
        """Rows 1-6: the LSTM kernels of both cells and the GRU kernels
        against their plain versions at every KERNEL_SHAPES entry in fp32
        and bf16, then under autograd at GRAD_SHAPES, and one
        ``Bidirectional(GRU)`` forward."""
        torch = self.torch
        for dtype in (torch.float32, torch.bfloat16):
            for T, B, H in KERNEL_SHAPES:
                for cell, peep, mask in CELLS:
                    self.check_kernels(cell, T, B, H, dtype, peep, mask)
        for T, B, H in GRAD_SHAPES:
            for cell, peep, mask in CELLS:
                self.check_autograd(cell, T, B, H, peep, mask)
        for dtype in (torch.float32, torch.bfloat16):
            for T, B, H in KERNEL_SHAPES:
                self.check_gru(T, B, H, dtype)
        for (T, B, H), pair in GRU_EDGE_SHAPES.items():
            self.check_gru(T, B, H, torch.bfloat16, pair)
        for T, B, H in GRAD_SHAPES:
            self.check_gru_autograd(T, B, H)
        self.check_bidirectional_gru()

    def flash_checks(self):
        """Row 7 (both instances) at every FLASH_SHAPES entry and on
        unaligned views, then rows 8-9 (the backward kernels)."""
        torch = self.torch
        for dtype in (torch.float32, torch.bfloat16):
            for shape in FLASH_SHAPES:
                self.check_flash(shape, dtype)
            self.check_flash(FLASH_UNALIGNED, dtype, offset=1)
        self.flash_backward_checks()

    def conv_stats_checks(self):
        """conv_stats against its plain version at CONV_STATS_SHAPES in fp32
        and bf16, and in bf16 with x one element into its buffer, a nonzero
        shift, inputs off zero mean (as a ReLU's output is); a second launch
        bit for bit; the kernel each case ran, by the profiler's names."""
        torch = self.torch
        for dtype in (torch.float32, torch.bfloat16):
            for shape in CONV_STATS_SHAPES:
                self.check_conv_stats(shape, dtype)
        self.check_conv_stats(CONV_STATS_UNALIGNED, torch.bfloat16, offset=1)

    def check_conv_stats(self, shape, dtype, offset=0):
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import conv_stats as cs
        m, k, n = shape
        dname = str(dtype).replace("torch.", "")
        g = torch.Generator(device=self.device).manual_seed(m + k + n)
        x = (torch.rand(m, k, generator=g, device=self.device) * 2.0).to(dtype)
        w = (torch.randn(k, n, generator=g, device=self.device) * k ** -0.5).to(dtype)
        shift = torch.randn(n, generator=g, device=self.device)
        if offset:
            x = shifted(x, offset)
        with torch.no_grad():
            got = cs.launch_conv_stats(x, w, shift)
            again = cs.launch_conv_stats(x, w, shift)
            torch.cuda.synchronize()
            want = cs.conv_stats_reference(x, w, shift)
            ran = self.conv_stats_kernels(lambda: cs.launch_conv_stats(x, w, shift))
        scale = float(want[0].float().abs().max())
        err_y = max_err(got[:1], want[:1]) / max(scale, 1e-30)
        err_s = max(max_err([a], [b], relative=True) for a, b in zip(got[1:], want[1:]))
        same = all(bits_equal(a, b) for a, b in zip(got, again))
        finite = all(bool(torch.isfinite(t.float()).all()) for t in got)
        tma = dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0 and not offset
        expect = "conv_stats_wgmma_kernel" if tma else f"conv_stats_kernel<{dname}>"
        where = f" offset={offset}" if offset else ""
        self.check(finite and same and err_y <= CONV_STATS_TOL[dname]
                   and err_s <= CONV_STATS_SUM_TOL and ran == [expect],
                   f"conv_stats {dname:8s} M={m} K={k} N={n}{where}: y max_err/max|y|="
                   f"{err_y:.3g} (tol {CONV_STATS_TOL[dname]:g}), s1/s2 max_rel_err="
                   f"{err_s:.3g} (tol {CONV_STATS_SUM_TOL:g}); a second launch bit for "
                   f"bit: {same}; ran {' + '.join(ran)} (expected {expect})")
        if dtype == torch.bfloat16 and shape == CONV_STATS_SHAPES[0] and not offset:
            self.kernels.setdefault(cs.counter.name, {})["max_abs_err"] = \
                max_err(got[:1], want[:1])

    def conv_stats_kernels(self, run, tries=5):
        """The tile kernels one launch of conv_stats runs, by the profiler's
        names: ``conv_stats_wgmma_kernel`` (any BN) or ``conv_stats_kernel<T>``,
        beside which ``column_sums_kernel`` must run once. A session that did
        not see the sum kernel and one tile kernel once each (one that lost a
        record) is taken again."""
        ran = []
        for _ in range(tries):
            per, _ = self.profile_kernels(run, 1)
            sums = [n for name, (_, n) in per.items() if "column_sums_kernel" in name]
            tiles = [n for name, (_, n) in per.items()
                     if "conv_stats" in name and "column_sums_kernel" not in name]
            if sums == [1] and tiles == [1]:
                break
        for name in per:
            if "conv_stats_wgmma_kernel" in name:
                ran.append("conv_stats_wgmma_kernel")
            elif mt := re.search(r"conv_stats_kernel<(float|__nv_bfloat16)>", name):
                ran.append("conv_stats_kernel<float32>" if mt[1] == "float" else
                           "conv_stats_kernel<bfloat16>")
        return sorted(ran)

    def flash_backward_checks(self):
        """Rows 8-9: the backward kernels at every FLASH_SHAPES entry, at
        T=16384 causal and on unaligned views, in fp32 and bf16; then the
        autograd Function in fp32."""
        torch = self.torch
        for dtype in (torch.float32, torch.bfloat16):
            for shape in FLASH_SHAPES + [FLASH_LONG_SHAPE]:
                self.check_flash_bwd(shape, dtype)
            self.check_flash_bwd(FLASH_UNALIGNED, dtype, offset=1)
        for shape in FLASH_SHAPES:
            if not (shape[6] and shape[0] >= 3):  # no fully masked row
                self.check_flash_autograd(shape)

    def check_flash_bwd(self, shape, dtype, offset=0):
        """The two backward kernels against the plain backward on the same
        inputs: o and lse from the saving forward kernel, a random dO; with
        ``offset`` > 0, q, k, v, o and dO start that many elements into
        their buffers. A second launch must give the same bits. The line
        names the kernels the dispatch takes by width (bf16 at d, d_v <=
        128: the tensor-core pair, with the staging the launcher chooses
        over the eight operands; else the CUDA-core pair)."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        b, h, t_q, t_k, d, d_v, masked, causal = shape
        dname = str(dtype).replace("torch.", "")
        (q, k, v), mask = flash_inputs(b, h, t_q, t_k, d, d_v, dtype, self.device,
                                       seed=t_q + 5 * t_k + d, mask=masked)
        bias = fa.key_bias(mask, b, t_k)
        g = torch.Generator().manual_seed(t_q + d_v)
        with torch.no_grad():
            o, lse = fa.launch_flash_fwd(q, k, v, bias, causal, fa.lse_counter, save=True)
            do = torch.randn(b, h, t_q, d_v, generator=g).to(dtype).to(self.device)
            if offset:
                q, k, v, o, do = (shifted(x, offset) for x in (q, k, v, o, do))
            got = fa.launch_flash_bwd(q, k, v, o, lse, do, bias, causal)
            again = fa.launch_flash_bwd(q, k, v, o, lse, do, bias, causal)
            torch.cuda.synchronize()
            want = fa.flash_attention_backward_reference(q, k, v, o, lse, do, mask, causal)
            torch.cuda.synchronize()
        tol = FLASH_BWD_TOL[dname]
        peaks = [float(y.float().abs().max()) for y in want]
        errs = [max_err([x], [y]) / (p or 1.0) for x, y, p in zip(got, want, peaks)]
        finite = all(bool(torch.isfinite(x.float()).all()) for x in got)
        same = all(bits_equal(x, y) for x, y in zip(got, again))
        if dtype == torch.bfloat16 and max(d, d_v) <= 128:
            route = "mma " + stage_tag(fa, (q, k, v, o, do, *fa.grad_buffers(q, k, v)), offset)
        else:
            route = "cuda-core" + (f" offset={offset}" if offset else "")
        self.check(finite and same and max(errs) <= tol,
                   f"flash_attention_bwd   {dname:8s} b={b:2d} h={h:2d} t_q={t_q:5d} "
                   f"t_k={t_k:5d} d={d:3d} d_v={d_v:3d} mask={'yes' if masked else 'no '} "
                   f"causal={'yes' if causal else 'no '} {route}: max_rel_err dq={errs[0]:.3g} "
                   f"dk={errs[1]:.3g} dv={errs[2]:.3g} tol={tol:g} (max |plain| "
                   + " ".join(f"{p:.3g}" for p in peaks) + f"); a second launch bit for bit: "
                   f"{same}")
        if shape == FLASH_SHAPES[1] and dtype == torch.bfloat16:  # masked, as trained
            self.kernels.setdefault(fa.bwd_dq_counter.name, {})["max_abs_err"] = \
                max_err(got[:1], want[:1])
            self.kernels.setdefault(fa.bwd_dkv_counter.name, {})["max_abs_err"] = \
                max_err(got[1:], want[1:])
        del q, k, v, o, lse, do, got, again, want
        torch.cuda.empty_cache()

    def check_flash_autograd(self, shape):
        """``flash_attention`` under autograd (saving forward + backward
        kernels) against ``torch.autograd`` of the plain forward, float32."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        b, h, t_q, t_k, d, d_v, masked, causal = shape
        (q, k, v), mask = flash_inputs(b, h, t_q, t_k, d, d_v, torch.float32, self.device,
                                       seed=7 * t_q + d, mask=masked)
        g = torch.Generator().manual_seed(t_k + d)
        do = torch.randn(b, h, t_q, d_v, generator=g).to(self.device)
        before = (fa.bwd_dq_counter.value, fa.bwd_dkv_counter.value)
        grads = []
        for run in (fa.flash_attention,
                    lambda *a, causal: fa.flash_attention_reference(*a, causal=causal)[0]):
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            out = run(*leaves, mask, causal=causal)
            grads.append(torch.autograd.grad(out, leaves, do))
        torch.cuda.synchronize()
        launched = (fa.bwd_dq_counter.value - before[0], fa.bwd_dkv_counter.value - before[1])
        errs = [max_err([x], [y], relative=True) for x, y in zip(*grads)]
        self.check(max(errs) <= FLASH_GRAD_TOL and launched == (1, 1),
                   f"flash_attention autograd vs plain float32 b={b:2d} h={h:2d} t_q={t_q:4d} "
                   f"t_k={t_k:4d} d={d:3d} d_v={d_v:3d} mask={'yes' if masked else 'no '} "
                   f"causal={'yes' if causal else 'no '} max_rel_err dq={errs[0]:.3g} "
                   f"dk={errs[1]:.3g} dv={errs[2]:.3g} tol={FLASH_GRAD_TOL:g}; backward "
                   f"launches {launched} (expected (1, 1))")

    def check_flash(self, shape, dtype, offset=0):
        """Both flash instances (inference: o; saving: o and lse) against
        the plain version on the same inputs; ``offset`` > 0 hands the
        kernel views that start that many elements into their buffers.
        The line names the bf16 kernel's staging (cp.async or element by
        element), which the launcher chooses from the pointers and
        strides."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        b, h, t_q, t_k, d, d_v, masked, causal = shape
        dname = str(dtype).replace("torch.", "")
        (q, k, v), mask = flash_inputs(b, h, t_q, t_k, d, d_v, dtype, self.device,
                                       seed=t_q + 3 * t_k + d_v, mask=masked)
        if offset:
            q, k, v = (shifted(x, offset) for x in (q, k, v))
        bias = fa.key_bias(mask, b, t_k)
        with torch.no_grad():
            got = fa.launch_flash_fwd(q, k, v, bias, causal, fa.counter)
            got_o, got_lse = fa.launch_flash_fwd(q, k, v, bias, causal, fa.lse_counter, save=True)
            torch.cuda.synchronize()
            want_o, want_lse = fa.flash_attention_reference(q, k, v, mask, causal)
        torch.cuda.synchronize()
        tol_o, tol_lse = FLASH_TOL[dname]
        tag = (f"{dname:8s} b={b:2d} h={h:2d} t_q={t_q:4d} t_k={t_k:4d} d={d:3d} d_v={d_v:3d} "
               f"mask={'yes' if masked else 'no '} causal={'yes' if causal else 'no '} "
               f"{stage_tag(fa, (q, k, v), offset)}")
        err = max_err([got], [want_o])
        err_o, err_lse = max_err([got_o], [want_o]), max_err([got_lse], [want_lse])
        finite = all(bool(torch.isfinite(x.float()).all()) for x in (got, got_o))
        self.check(finite and err <= tol_o,
                   f"{fa.counter.name:22s} {tag} o max_abs_err={err:.3g} tol={tol_o:g}")
        self.check(finite and err_o <= tol_o and err_lse <= tol_lse,
                   f"{fa.lse_counter.name:22s} {tag} o max_abs_err={err_o:.3g} tol={tol_o:g}, "
                   f"lse max_abs_err={err_lse:.3g} tol={tol_lse:g}")
        if shape == FLASH_SHAPES[0] and dtype == torch.bfloat16:
            self.kernels.setdefault(fa.counter.name, {})["max_abs_err"] = err
        if shape == FLASH_SHAPES[1] and dtype == torch.bfloat16:  # masked, as trained
            self.kernels.setdefault(fa.lse_counter.name, {})["max_abs_err"] = max(err_o, err_lse)

    def dropout_checks(self):
        torch = self.torch
        for dtype in (torch.float32, torch.bfloat16):
            for shape in DROPOUT_SHAPES:
                for rate in DROPOUT_RATES:
                    for with_x in (False, True):
                        self.check_dropout(shape, dtype, rate, with_x)
        self.check_dropout((4 * 1001 + 3,), torch.bfloat16, 0.1, True, offset=1)

    def check_dropout(self, shape, dtype, rate, with_x, offset=0):
        """The dropout kernel against its plain version, bitwise: the
        forward (with ``x`` when ``with_x``), the backward launch on a
        random gy (its mask must be the forward's), the same seed again
        (same bits) and seed + 1 (another mask), and the keep fraction.
        ``offset`` > 0 reads views that start that many elements into their
        buffers, which the kernel takes element by element."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import fused_dropout as fd
        dname = str(dtype).replace("torch.", "")
        n = math.prod(shape)
        seed = n + int(rate * 100) - 2 ** 31  # negative: the bit pattern is the key
        g = torch.Generator().manual_seed(n + with_x)

        def tensor():
            t = torch.randn(n + offset, generator=g)
            t = torch.where(t == 0, torch.ones(()), t)  # a kept 0 would read as dropped
            return t.to(dtype).to(self.device)[offset:].view(shape)

        h, gy = tensor(), tensor()
        x = tensor() if with_x else None
        with torch.no_grad():
            got = fd.launch_dropout(x, h, seed, rate, fd.counter)
            fwd_mask = fd.launch_dropout(None, h, seed, rate, fd.counter) != 0
            dh = fd.launch_dropout(None, gy, seed, rate, fd.bwd_counter)
            again = fd.launch_dropout(x, h, seed, rate, fd.counter)
            other = fd.launch_dropout(None, h, seed + 1, rate, fd.counter) != 0
            torch.cuda.synchronize()
            want = fd.fused_dropout_reference(x, h, seed, rate)
            want_dh = fd.fused_dropout_reference(None, gy, seed, rate)
            kept = fd.keep_mask(n, seed, rate, self.device).view(shape)
        torch.cuda.synchronize()
        keep = 1.0 - rate
        n_kept = int(kept.sum())
        in_bounds = abs(n_kept - n * keep) <= DROPOUT_SIGMAS * math.sqrt(n * keep * rate) + 1
        differs = bool((other != fwd_mask).any()) if rate > 0 and n >= 64 else True
        ok = (bits_equal(got, want) and bits_equal(dh, want_dh) and bits_equal(again, got)
              and torch.equal(fwd_mask, kept) and torch.equal(dh != 0, kept) and in_bounds
              and differs)
        err = max_err([got], [want])
        self.check(ok, f"{fd.counter.name:22s} {dname:8s} shape={str(shape):13s} rate={rate:.1f} "
                       f"x={'yes' if with_x else 'no '}{f' offset={offset}' if offset else ''}: "
                       f"fwd, bwd, same seed bitwise = plain; bwd mask = fwd mask; kept "
                       f"{n_kept / n:.4f} (keep {keep:.1f}, {DROPOUT_SIGMAS:g} sigma: "
                       f"{in_bounds}); seed+1 differs: {differs}; max abs err {err:g}")
        if shape == DROPOUT_SHAPES[0] and dtype == torch.bfloat16 and rate == 0.1 and not with_x:
            self.kernels.setdefault(fd.counter.name, {})["max_abs_err"] = err
            self.kernels.setdefault(fd.bwd_counter.name, {})["max_abs_err"] = \
                max_err([dh], [want_dh])

    def short_attention_checks(self):
        torch = self.torch
        for dtype in (torch.float32, torch.bfloat16):
            for shape in SHORT_SHAPES:
                for btd in (False, True):
                    self.check_short(shape, dtype, btd)
            for btd in (False, True):
                self.check_short(SHORT_UNALIGNED, dtype, btd, offset=1)
        for shape in (SHORT_SHAPES[1], SHORT_SHAPES[4]):
            for btd in (False, True):
                self.check_short_autograd(shape, btd)
        self.check_short_dispatch()

    def check_short(self, shape, dtype, btd, offset=0):
        """The short-attention forward and backward kernels against their
        plain versions on the same inputs and dO, in the (b, h, t, d) layout
        or through the (b, h, t, d) views of (b, t, h*d) tensors; with
        ``offset`` > 0 the tensors start that many elements into their
        buffers."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import fused_attention_short as sa
        b, h, t, d, masked = shape
        dname = str(dtype).replace("torch.", "")
        (q, k, v), mask = flash_inputs(b, h, t, t, d, d, dtype, self.device,
                                       seed=t + 11 * d + btd, mask=masked)
        g = torch.Generator().manual_seed(t + d)
        do = torch.randn(b, h, t, d, generator=g).to(dtype).to(self.device)
        if btd:
            flat, _ = btd_views([q, k, v, do], h)
            flat = [shifted(x, offset) if offset else x for x in flat]
            q, k, v, do = (x.view(b, t, h, d).transpose(1, 2) for x in flat)
        elif offset:
            q, k, v, do = (shifted(x, offset) for x in (q, k, v, do))
        bias, scale = sa.key_bias(mask, b, t), d ** -0.5
        fwd_c, bwd_c = (sa.btd_counter, sa.btd_bwd_counter) if btd else (sa.counter,
                                                                            sa.bwd_counter)
        with torch.no_grad():
            o = sa.launch_short_fwd(q, k, v, bias, scale, fwd_c, btd)
            grads = sa.launch_short_bwd(q, k, v, do, bias, scale, bwd_c, btd)
            torch.cuda.synchronize()
            want_o = sa.short_attention_reference(q, k, v, mask, scale)
            want = sa.short_attention_backward_reference(q, k, v, do, mask, scale)
        torch.cuda.synchronize()
        err_o = max_err([o], [want_o])
        peaks = [float(y.float().abs().max()) for y in want]
        errs = [max_err([x], [y]) / (p or 1.0) for x, y, p in zip(grads, want, peaks)]
        finite = all(bool(torch.isfinite(x.float()).all()) for x in (o, *grads))
        tol, tol_b = SHORT_TOL[dname], SHORT_BWD_TOL[dname]
        tag = (f"{dname:8s} {'btd ' if btd else 'bhtd'} b={b:2d} h={h:2d} t={t:3d} d={d:3d} "
               f"mask={'yes' if masked else 'no '} {stage_tag(sa, (q, k, v), offset)}")
        self.check(finite and err_o <= tol,
                   f"{fwd_c.name:23s} {tag} o max_abs_err={err_o:.3g} tol={tol:g}")
        self.check(finite and max(errs) <= tol_b,
                   f"{bwd_c.name:23s} {tag} max_rel_err dq={errs[0]:.3g} dk={errs[1]:.3g} "
                   f"dv={errs[2]:.3g} tol={tol_b:g} (max |plain| "
                   + " ".join(f"{p:.3g}" for p in peaks) + ")")
        if shape == SHORT_SHAPES[1] and dtype == torch.bfloat16:  # unmasked, as the ops phase
            self.kernels.setdefault(fwd_c.name, {})["max_abs_err"] = err_o
            self.kernels.setdefault(bwd_c.name, {})["max_abs_err"] = max(errs)
        if shape == SHORT_SHAPES[0] and dtype == torch.bfloat16:  # masked BERT-base
            with torch.no_grad():
                again = sa.launch_short_bwd(q, k, v, do, bias, scale, bwd_c, btd)
            torch.cuda.synchronize()
            same = all(bits_equal(x, y) for x, y in zip(grads, again))
            self.check(same, f"{bwd_c.name:23s} {tag} a second launch gives the same dq, dk "
                             f"and dv bit for bit: {same}")

    def pair_kernels(self, run, what, reps=10, tries=5):
        """Device ms of each kernel that ``run`` (one launch of a backward
        pair: each kernel once) starts, by ``torch.profiler``: ``{kernel
        name: ms per launch}``, each kernel's device time over the launches
        the session saw, so that a lost event does not bias it. A session
        that lost events (a kernel seen other than once a call) is taken
        again, up to ``tries`` times; then each kernel's time is from the
        last session that saw it."""
        seen = {}
        for _ in range(tries):
            per, _ = self.profile_kernels(run, reps)
            seen.update({k: (ms / n, n) for k, (ms, n) in per.items()})
            if len(per) == 2 and all(n == 1 for _, n in per.values()):
                return {k: ms / n for k, (ms, n) in per.items()}
        log(f"{what}: {tries} profiler sessions lost events; each kernel's time per launch is "
            f"from the last session that saw it ({ {k: n for k, (_, n) in seen.items()} } a "
            "call)")
        return {k: ms for k, (ms, _) in seen.items()}

    def check_short_dispatch(self):
        """Which backward pair a launch runs, by the kernel names the
        profiler sees: bf16 with d <= 128 the tensor-core pair (the dq
        kernel resident at t <= 128, in three passes beyond), float32 and
        bf16 with d > 128 the CUDA-core pair."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import fused_attention_short as sa
        for dtype, t, d, mma in ((torch.bfloat16, 128, 64, True), (torch.bfloat16, 129, 128, True),
                                 (torch.bfloat16, 100, 256, False), (torch.float32, 128, 64, False)):
            (q, k, v), _ = flash_inputs(2, 2, t, t, d, d, dtype, self.device, seed=4, mask=False)
            do = torch.randn_like(q)
            with torch.no_grad():
                names = sorted(self.pair_kernels(
                    lambda: sa.launch_short_bwd(q, k, v, do, None, d ** -0.5, sa.bwd_counter),
                    "short attention backward", reps=2))
            got = [m[0] if (m := re.search(r"short_bwd_(dq|dkv)_kernel(_mma)?", n)) else n
                   for n in names]
            want = [f"short_bwd_{w}_kernel{'_mma' if mma else ''}" for w in ("dkv", "dq")]
            dname = str(dtype).replace("torch.", "")
            self.check(got == want, f"short attention backward {dname} t={t} d={d} runs "
                                    f"{' + '.join(names)} (expected {' + '.join(want)})")

    def check_short_autograd(self, shape, btd):
        """``short_attention`` (or ``short_attention_btd``) under autograd
        against ``torch.autograd`` of the plain forward, float32, with the
        launch counts of the call (one forward, one backward)."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import fused_attention_short as sa
        b, h, t, d, masked = shape
        (q, k, v), mask = flash_inputs(b, h, t, t, d, d, torch.float32, self.device,
                                       seed=3 * t + d, mask=masked)
        g = torch.Generator().manual_seed(5 * t + d)
        do = torch.randn(b, h, t, d, generator=g).to(self.device)
        if btd:
            (q, k, v, do), _ = btd_views([q, k, v, do], h)
        counters = (sa.btd_counter, sa.btd_bwd_counter) if btd else (sa.counter, sa.bwd_counter)
        before = [c.value for c in counters]
        grads = []
        for plain in (False, True):
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            if btd:
                args = [x.view(b, t, h, d).transpose(1, 2) for x in leaves]
                out = sa.short_attention_reference(*args, mask).transpose(1, 2).reshape(
                    b, t, h * d) if plain else sa.short_attention_btd(*leaves, mask, heads=h)
            else:
                out = sa.short_attention_reference(*leaves, mask) if plain else \
                    sa.short_attention(*leaves, mask)
            grads.append(torch.autograd.grad(out, leaves, do))
        torch.cuda.synchronize()
        launched = tuple(c.value - n for c, n in zip(counters, before))
        errs = [max_err([x], [y], relative=True) for x, y in zip(*grads)]
        self.check(max(errs) <= SHORT_GRAD_TOL and launched == (1, 1),
                   f"{counters[0].name} autograd vs plain float32 b={b:2d} h={h:2d} t={t:3d} "
                   f"d={d:3d} mask={'yes' if masked else 'no '} max_rel_err dq={errs[0]:.3g} "
                   f"dk={errs[1]:.3g} dv={errs[2]:.3g} tol={SHORT_GRAD_TOL:g}; launches "
                   f"{launched} (expected (1, 1))")

    def ops_phase(self):
        """The entry points of rows 10-12 driven under autograd as
        ``bench.py:572-626`` (``verify_kernels``) drives the JAX package's:
        ``short_attention`` and ``short_attention_btd`` at (64, 12, 128, 64)
        bf16, forward and the gradient of sum(o^2) in q, against a dense
        fp32 softmax; ``fused_dropout`` at 8192 x 768 bf16, rate 0.1, with
        its zero fraction and the gradient's mask. The launch counts of the
        run must be one forward and one backward of each kernel, nothing
        else."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import fused_attention_short as sa
        from deeplearning4j_tpu_torch.ops.kernels import fused_dropout as fd
        b, h, t, d = OPS_SHORT
        dt = torch.bfloat16
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(b, h, t, d, generator=g).to(dt).to(self.device) for _ in range(3))
        (q3, k3, v3), _ = btd_views([q, k, v], h)
        hd = torch.randn(*DROPOUT_SHAPES[0], generator=g).to(dt).to(self.device)
        seed = fd.seed_from_key(torch.Generator().manual_seed(3))

        def dense(q_, k_, v_):  # bench.py's xla_short, on (b, h, t, d)
            s = torch.matmul(q_.float(), k_.float().transpose(-1, -2)) / math.sqrt(d)
            return torch.matmul(torch.softmax(s, -1), v_.float()).to(q_.dtype)

        def heads(x):
            return x.view(b, t, h, d).transpose(1, 2)

        def merge(x):
            return x.transpose(1, 2).reshape(b, t, h * d)

        def bench(fn, q_):  # the output and the gradient of sum(o^2) in q
            leaf = q_.detach().clone().requires_grad_()
            out = fn(leaf)
            (grad,) = torch.autograd.grad((out.float() ** 2).sum(), [leaf])
            return out.detach(), grad

        counters = all_counters()
        # ---- the main path: counts from 0 just before, read just after
        torch.cuda.synchronize()
        for c in counters:
            c.reset()
        o_k, g_k = bench(lambda x: sa.short_attention(x, k, v), q)
        o_b, g_b = bench(lambda x: sa.short_attention_btd(x, k3, v3, heads=h), q3)
        hl = hd.detach().clone().requires_grad_()
        yd = fd.fused_dropout(hl, seed, 0.1)
        (gd,) = torch.autograd.grad(yd.float().sum(), [hl])
        torch.cuda.synchronize()
        counts = {c.name: c.value for c in counters}
        # ----
        want = {c.name: 0 for c in counters}
        for c in (sa.counter, sa.bwd_counter, sa.btd_counter, sa.btd_bwd_counter, fd.counter,
                  fd.bwd_counter):
            want[c.name] = 1
            self.add_launches({c.name: counts[c.name]})
        self.check(counts == want, f"ops launch counts: {counts} (expected one forward and one "
                                   "backward of each of short_attention, short_attention_btd "
                                   "and fused_dropout, nothing else)")
        for name, (o, gq), (o_x, g_x) in (
                ("short_attention", (o_k, g_k), bench(lambda x: dense(x, k, v), q)),
                ("short_attention_btd", (o_b, g_b),
                 bench(lambda x: merge(dense(heads(x), heads(k3), heads(v3))), q3))):
            err_f = max_err([o], [o_x])
            gscale = float(g_x.float().abs().max())
            err_b = max_err([gq], [g_x])
            self.check(err_f <= OPS_FWD_TOL and err_b <= OPS_GRAD_TOL * max(gscale, 1.0),
                       f"ops {name} b={b} h={h} t={t} d={d} bf16 vs dense fp32 softmax: "
                       f"fwd max_abs_err={err_f:.4f} (limit {OPS_FWD_TOL}), grad max_abs_err="
                       f"{err_b:.4f} (limit {OPS_GRAD_TOL} x max(max |g| = {gscale:.3g}, 1))")
        frac = float((yd == 0).float().mean())
        mask_match = bool(torch.equal(gd != 0, yd != 0))
        lo, hi = OPS_ZERO_FRAC
        self.check(lo < frac < hi and mask_match,
                   f"ops fused_dropout {tuple(hd.shape)} bf16 rate 0.1 seed {int(seed)}: zero "
                   f"fraction {frac:.4f} (limits {lo}, {hi}); backward mask regenerated "
                   f"identically: {mask_match}")

    def check_kernels(self, cell, T, B, H, dtype, peep, mask):
        """The inference forward, the saving forward and the backward kernel
        of one cell against their plain versions, on the same inputs; the
        backward of both sides reads the plain forward's residuals."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import fused_lstm as fl
        mod = self.cell_module(cell)
        dname = str(dtype).replace("torch.", "")
        a = lstm_inputs(T, B, H, dtype, self.device, seed=T * 7 + B, peep=peep, mask=mask)
        fwd = (a["zx"], a["w_rec"], a["peep"], a["h0"], a["c0"], a["mask"])
        with torch.no_grad():
            got = fl.launch_lstm_fwd(*fwd, mod.counter)
            got_save = fl.launch_lstm_fwd(*fwd, mod.save_counter, save=True)
            want_save = fl.lstm_reference(*fwd, save=True)
            g = torch.Generator().manual_seed(T * 11 + B)
            cot = [torch.randn(s, generator=g).to(dtype).to(self.device)
                   for s in ((T, B, H), (B, H), (B, H))]
            gates, cseq = want_save[3], want_save[4]
            bwd = (*cot, gates, cseq, a["c0"], a["w_rec"], a["peep"], a["mask"])
            got_bwd = fl.launch_lstm_bwd(*bwd, mod.bwd_counter)
            torch.cuda.synchronize()
            want_bwd = fl.lstm_bwd_reference(*bwd)
        torch.cuda.synchronize()
        tag = f"{dname:8s} T={T:3d} B={B:3d} H={H:3d} mask={'yes' if mask else 'no '}"
        pair = LSTM_ROW_GROUP if dtype == torch.bfloat16 and H % 8 == 0 else LSTM_CUDA_CORE
        errs = self.hold_recurrent(tag, pair, B, lambda: (
            fl.launch_lstm_fwd(*fwd, mod.counter),
            fl.launch_lstm_fwd(*fwd, mod.save_counter, save=True),
            fl.launch_lstm_bwd(*bwd, mod.bwd_counter)), (
            (mod.counter.name, got, want_save[:3], KERNEL_TOL[dname], False),
            (mod.save_counter.name, got_save, want_save, KERNEL_TOL[dname], False),
            (mod.bwd_counter.name, got_bwd, want_bwd, BWD_TOL[dname], True)))
        if (T, B, H) == KERNEL_SHAPES[0] and dtype == torch.bfloat16 and not mask:
            for name, err in errs.items():
                self.kernels.setdefault(name, {})["max_abs_err"] = err
        if mask:  # an all-masked row: no gradient reaches its inputs
            zero = float(got_bwd[0][:, 0].float().abs().max())
            self.check(zero == 0.0, f"{mod.bwd_counter.name:22s} {tag} all-masked row: "
                                    f"max |ds| = {zero:g} (expected 0)")

    def hold_recurrent(self, tag, pair, B, launch, cases):
        """The three launches of a recurrent check (inference forward,
        saving forward, backward: ``launch()`` returns their outputs) again,
        a warm-up and the profiled calls: the kernels the profiler names
        against ``pair`` (forward, backward; one launch per group of at most
        64 rows), and every repeat bit for bit the first launches. ``cases``
        holds (counter name, first outputs, plain outputs, tolerance,
        relative) for the three in order; each error must be within its
        tolerance. Returns ``{counter name: error}``."""
        torch = self.torch
        n = -(-B // 64)
        fwd_k, bwd_k = pair
        expect = {fwd_k: 2 * n, bwd_k: n}
        again = []
        with torch.no_grad():
            ran = self.recurrent_kernels(lambda: again.append(launch()), expect)
        errs = {}
        for i, ((name, got, want, tol, rel), kern) in enumerate(zip(cases, (fwd_k, fwd_k, bwd_k))):
            err = errs[name] = max_err(got, want, relative=rel)
            finite = all(bool(torch.isfinite(x.float()).all()) for x in got)
            same = all(bits_equal(x, y) for run in again for x, y in zip(got, run[i]))
            self.check(finite and err <= tol and same and ran == expect,
                       f"{name:22s} {tag} max_{'rel' if rel else 'abs'}_err={err:.3g} "
                       f"tol={tol:g}; {len(again)} more launches bit for bit: {same}; ran "
                       f"{kern} (the three launches: {ran}, expected {expect})")
        return errs

    def check_autograd(self, cell, T, B, H, peep, mask):
        """The whole autograd wrapper in float32: gradients of every
        differentiable input against ``torch.autograd`` of the plain
        forward."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import fused_lstm as fl
        mod = self.cell_module(cell)
        a = lstm_inputs(T, B, H, torch.float32, self.device, seed=T + B, peep=peep, mask=mask)
        names = [k for k in ("zx", "w_rec", "peep", "h0", "c0") if a[k] is not None]
        g = torch.Generator().manual_seed(T * 13 + B)
        cot = [torch.randn(s, generator=g).to(self.device) for s in ((T, B, H), (B, H), (B, H))]
        grads = []
        for run in (self.run_wrapper(cell, mod), fl.lstm_reference):
            leaves = {k: a[k].detach().clone().requires_grad_() for k in names}
            args = {**a, **leaves}
            ys, h_t, c_t = run(args["zx"], args["w_rec"], args["peep"], args["h0"],
                               args["c0"], args["mask"])
            loss = (ys * cot[0]).sum() + (h_t * cot[1]).sum() + (c_t * cot[2]).sum()
            grads.append(torch.autograd.grad(loss, [leaves[k] for k in names]))
        torch.cuda.synchronize()
        errs = {k: max_err([x], [y], relative=True) for k, x, y in zip(names, *grads)}
        worst = max(errs.values())
        self.check(worst <= GRAD_TOL,
                   f"{cell:18s} autograd vs plain float32 T={T:3d} B={B:3d} H={H:3d} "
                   f"mask={'yes' if mask else 'no '} max_rel_err "
                   + " ".join(f"{k}={v:.3g}" for k, v in errs.items()) + f" tol={GRAD_TOL:g}")

    @staticmethod
    def cell_module(cell):
        from deeplearning4j_tpu_torch.ops.kernels import fused_gru
        from deeplearning4j_tpu_torch.ops.kernels import fused_lstm as fl
        from deeplearning4j_tpu_torch.ops.kernels import fused_lstm_graves as fg
        return {"fused_lstm": fl, "fused_graves_lstm": fg, "fused_gru": fused_gru}[cell]

    def check_gru(self, T, B, H, dtype, pair=None):
        """The GRU's inference forward, saving forward (ys, hT, gates, zh_n)
        and backward (dzx, dh0) kernels against their plain versions on the
        same inputs; the backward of both sides reads the plain forward's
        residuals and ys. The three launches again: the kernels the profiler
        names (``pair``, else by design: the row-group pair for bf16 with
        H % 8 == 0, the CUDA-core pair otherwise), and every repeat bit for
        bit the first launches."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import fused_gru as fgru
        dname = str(dtype).replace("torch.", "")
        a = gru_inputs(T, B, H, dtype, self.device, seed=T * 5 + B)
        fwd = (a["zx"], a["w_rec"], a["h0"])
        with torch.no_grad():
            got = fgru.launch_gru_fwd(*fwd, fgru.counter)
            got_save = fgru.launch_gru_fwd(*fwd, fgru.save_counter, save=True)
            want_save = fgru.gru_reference(*fwd, save=True)
            g = torch.Generator().manual_seed(T * 17 + B)
            cot = [torch.randn(s, generator=g).to(dtype).to(self.device)
                   for s in ((T, B, H), (B, H))]
            ys, _, gates, zhn = want_save
            bwd = (*cot, gates, zhn, ys, a["h0"], a["w_rec"])
            got_bwd = fgru.launch_gru_bwd(*bwd, fgru.bwd_counter)
            torch.cuda.synchronize()
            want_bwd = fgru.gru_bwd_reference(*bwd)
        torch.cuda.synchronize()
        tag = f"{dname:8s} T={T:3d} B={B:3d} H={H:3d}"
        if pair is None:
            pair = GRU_ROW_GROUP if dtype == torch.bfloat16 and H % 8 == 0 else GRU_CUDA_CORE
        errs = self.hold_recurrent(tag, pair, B, lambda: (
            fgru.launch_gru_fwd(*fwd, fgru.counter),
            fgru.launch_gru_fwd(*fwd, fgru.save_counter, save=True),
            fgru.launch_gru_bwd(*bwd, fgru.bwd_counter)), (
            (fgru.counter.name, got, want_save[:2], KERNEL_TOL[dname], False),
            (fgru.save_counter.name, got_save, want_save, KERNEL_TOL[dname], False),
            (fgru.bwd_counter.name, got_bwd, want_bwd, BWD_TOL[dname], True)))
        if (T, B, H) == KERNEL_SHAPES[0] and dtype == torch.bfloat16:
            for name, err in errs.items():
                self.kernels.setdefault(name, {})["max_abs_err"] = err

    def check_gru_autograd(self, T, B, H):
        """``fused_gru`` under autograd in float32 (``FusedGRUFunction``:
        saving forward + backward kernel + the dW_rec product): dzx, dW_rec
        and dh0 against ``torch.autograd`` of the plain forward."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import fused_gru as fgru
        a = gru_inputs(T, B, H, torch.float32, self.device, seed=T + 3 * B)
        names = ["zx", "w_rec", "h0"]
        g = torch.Generator().manual_seed(T * 19 + B)
        cot = [torch.randn(s, generator=g).to(self.device) for s in ((T, B, H), (B, H))]
        before = (fgru.save_counter.value, fgru.bwd_counter.value)
        grads = []
        for run in (fgru.fused_gru, fgru.gru_reference):
            leaves = [a[k].detach().clone().requires_grad_() for k in names]
            ys, h_t = run(*leaves)
            loss = (ys * cot[0]).sum() + (h_t * cot[1]).sum()
            grads.append(torch.autograd.grad(loss, leaves))
        torch.cuda.synchronize()
        launched = (fgru.save_counter.value - before[0], fgru.bwd_counter.value - before[1])
        n_launch = -(-B // 64)  # one launch per group of at most 64 rows
        errs = {k: max_err([x], [y], relative=True) for k, x, y in zip(names, *grads)}
        self.check(max(errs.values()) <= GRAD_TOL and launched == (n_launch, n_launch),
                   f"fused_gru          autograd vs plain float32 T={T:3d} B={B:3d} H={H:3d} "
                   "max_rel_err " + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
                   + f" tol={GRAD_TOL:g}; launches (save, bwd) {launched} (expected "
                   f"{(n_launch, n_launch)})")

    def check_bidirectional_gru(self):
        """One ``Bidirectional(GRU)`` forward (float32, inference) against
        the same layer with the plain loop in place of the kernel: two
        launches, one per direction."""
        torch = self.torch
        from deeplearning4j_tpu_torch.nn import GRU, Bidirectional, GlobalConfig, InputType
        from deeplearning4j_tpu_torch.ops.kernels import fused_gru as fgru
        T, B, n_in = BIDI_SHAPE
        layer = Bidirectional(layer=GRU(n_out=HIDDEN))
        layer._g = GlobalConfig()
        params, _ = layer.init(torch.Generator().manual_seed(11),
                               InputType.recurrent(n_in, T), layer._g)
        params = {d: {k: v.to(self.device) for k, v in p.items()} for d, p in params.items()}
        x = torch.randn(B, T, n_in, generator=torch.Generator().manual_seed(12)).to(self.device)
        with torch.inference_mode():
            before = fgru.counter.value
            got, _ = layer.forward(params, {}, x)
            torch.cuda.synchronize()
            launched = fgru.counter.value - before
            with plain_recurrences():
                want, _ = layer.forward(params, {}, x)
        err = max_err([got], [want])
        self.check(got.shape == (B, T, 2 * HIDDEN) and err <= KERNEL_TOL["float32"]
                   and launched == 2,
                   f"Bidirectional(GRU) float32 T={T} B={B} H={HIDDEN} vs plain loop: "
                   f"max_abs_err={err:.3g} tol={KERNEL_TOL['float32']:g}; {launched} "
                   "launches (expected 2)")

    @staticmethod
    def run_wrapper(cell, mod):
        """The public wrapper with the (zx, w_rec, peep, h0, c0, mask)
        argument list."""
        if cell == "fused_lstm":
            return lambda zx, w, p, h0, c0, m: mod.fused_lstm(zx, w, h0, c0)
        return mod.fused_graves_lstm

    def plain_forward(self, net, x):
        """The network's forward with every kernel replaced by its plain
        version: the reference the served answers are held against."""
        torch = self.torch
        from deeplearning4j_tpu_torch.nn.base import cast_floating
        from deeplearning4j_tpu_torch.nn.recurrent_layers import GRU, LSTM
        from deeplearning4j_tpu_torch.ops.kernels.fused_gru import gru_reference
        from deeplearning4j_tpu_torch.ops.kernels.fused_lstm import lstm_reference
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        cdt = get_environment().compute_dtype
        h = torch.as_tensor(x, device=net.device).to(cdt)
        params = cast_floating(net.params(), cdt)
        with torch.inference_mode():
            for i, layer in enumerate(net.layers):
                p = params[layer.name or f"layer_{i}"]
                if isinstance(layer, LSTM):
                    zx = torch.matmul(h.transpose(0, 1), p["W"]) + p["b"]
                    zero = torch.zeros(h.shape[0], layer.n_out, dtype=cdt, device=h.device)
                    ys, _, _ = lstm_reference(zx, p["W_rec"], p.get("peephole"), zero,
                                              zero, None)
                    h = ys.transpose(0, 1)
                elif isinstance(layer, GRU):
                    zx = torch.matmul(h.transpose(0, 1), p["W"]) + p["b"]
                    zero = torch.zeros(h.shape[0], layer.n_out, dtype=cdt, device=h.device)
                    h = gru_reference(zx, p["W_rec"], zero)[0].transpose(0, 1)
                else:
                    h = layer.activate(p, h)
        return h.float().cpu().numpy()

    def slice_phase(self, cell, workdir):
        """The char-RNN of ``cell`` (``CHAR_RNN_TAGS``) served at full width:
        random weights from the seed, bf16 compute, written to an archive,
        loaded by ``ModelRegistry.load`` and served to 8 client threads;
        every answer against the plain forward, the launch counts, chunked
        ``rnn_time_step``, and the p50 of one 64-row request."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.models import ModelSerializer, MultiLayerNetwork
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.serving import ModelRegistry

        get_environment().allow_bfloat16()
        kernel = self.cell_module(CHAR_RNN_KERNELS[cell])
        tag = CHAR_RNN_TAGS[cell]
        net = MultiLayerNetwork(char_rnn_conf(cell, SERVE_T), device=self.device).init()
        path = os.path.join(workdir, f"char-rnn-{cell}.zip")
        ModelSerializer.write_model(net, path)
        reg = ModelRegistry()
        served = reg.load("char-rnn", path, device=self.device, max_batch_size=SERVE_B,
                          batch_timeout_ms=5.0)
        rng = np.random.default_rng(CHAR_RNN_SEEDS[cell] + 1234)
        rows = rng.integers(1, SERVE_B + 1, (CLIENTS, REQUESTS_PER_CLIENT))
        rows[0, 0], rows[1, 0] = 1, SERVE_B
        eye = np.eye(VOCAB, dtype=np.float32)
        reqs = [[eye[rng.integers(0, VOCAB, (int(n), SERVE_T))] for n in r] for r in rows]
        answers = [[None] * REQUESTS_PER_CLIENT for _ in range(CLIENTS)]
        lat = []
        errors = []
        lat_lock = threading.Lock()

        def client(c):
            try:
                for k, x in enumerate(reqs[c]):
                    t0 = time.perf_counter()
                    answers[c][k] = reg.predict("char-rnn", x)
                    with lat_lock:
                        lat.append(time.perf_counter() - t0)
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,), name=f"smoke-client-{c}")
                   for c in range(CLIENTS)]
        counters = all_counters()
        # ---- the main path: counts from 0 just before, read just after
        torch.cuda.synchronize()
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {c.name: c.value for c in counters}
        # ----
        batches = served.batcher.batches
        launched = counts[kernel.counter.name]
        self.check(not errors, f"{tag} serving: {len(lat)} requests answered, errors={errors}")
        want = {c.name: 0 for c in counters}
        want[kernel.counter.name] = LAYERS * batches
        self.check(counts == want,
                   f"{tag} launch counts over the serving run: {kernel.counter.name}="
                   f"{launched} (expected {LAYERS} layers x {batches} batches), every other "
                   f"kernel 0: {counts}")
        self.add_launches({kernel.counter.name: launched})
        log(f"{tag} {kernel.counter.name}: {launched / max(1, len(lat)):.2f} launches per "
            f"request, {launched / max(1, batches):.2f} per batch")
        worst = 0.0
        for c in range(CLIENTS):
            for k, x in enumerate(reqs[c]):
                got = answers[c][k]
                n = x.shape[0]
                bucket = next(b for b in served.batcher.buckets if b >= n)
                padded = np.zeros((bucket,) + x.shape[1:], np.float32)
                padded[:n] = x
                want = self.plain_forward(served.model, padded)[:n]
                ok = got is not None and got.shape == (n, SERVE_T, VOCAB) and \
                    bool(np.isfinite(got).all())
                worst = max(worst, float(np.abs(got - want).max()) if ok else float("inf"))
        self.check(worst <= SERVE_TOL,
                   f"{tag} {CLIENTS * REQUESTS_PER_CLIENT} served answers vs plain forward: "
                   f"max_abs_err={worst:.3g} tol={SERVE_TOL:g}")
        total_rows = int(rows.sum())
        lat_ms = sorted(1e3 * v for v in lat)
        log(f"{tag} serving: {len(lat)} requests, {total_rows} rows x {SERVE_T} steps in "
            f"{wall:.3f} s over {batches} batches (buckets {served.batcher.bucket_counts}); "
            f"latency p50 {lat_ms[len(lat_ms) // 2]:.2f} ms, max {lat_ms[-1]:.2f} ms; "
            f"{total_rows * SERVE_T / wall:.0f} tokens/s")

        # rnn_time_step in 4 chunks of 64 steps == the whole sequence
        model = served.model
        x = reqs[1][0][:8]
        whole = model.output(x).float().cpu().numpy()
        model.rnn_clear_previous_state()
        before = kernel.counter.value
        chunks = [model.rnn_time_step(x[:, s:s + 64]).float().cpu().numpy()
                  for s in range(0, SERVE_T, 64)]
        model.rnn_clear_previous_state()
        err = float(np.abs(np.concatenate(chunks, axis=1) - whole).max())
        self.check(err <= CHUNK_TOL and kernel.counter.value - before == LAYERS * 4,
                   f"{tag} rnn_time_step 4 x 64 steps vs whole sequence: "
                   f"max_abs_err={err:.3g} tol={CHUNK_TOL:g}; "
                   f"{kernel.counter.value - before} launches (expected {LAYERS * 4})")

        # one full-bucket request alone: latency and tokens/s
        x = reqs[1][0]  # SERVE_B rows
        reg.predict("char-rnn", x)  # warm-up
        ms = []
        for _ in range(20):
            t0 = time.perf_counter()
            reg.predict("char-rnn", x)
            ms.append(1e3 * (time.perf_counter() - t0))
        ms.sort()
        p50 = ms[len(ms) // 2]
        self.serve_p50_ms[cell] = p50
        log(f"{tag} one {SERVE_B}-row request at a time, {len(ms)} requests: p50 "
            f"{p50:.2f} ms (min {ms[0]:.2f}, max {ms[-1]:.2f}), "
            f"{SERVE_B * SERVE_T / p50 * 1e3:.0f} tokens/s at p50")
        expect = {CHAR_RNN_RAN[cell][0]: LAYERS}
        ran = self.recurrent_kernels(lambda: reg.predict("char-rnn", x), expect)
        self.check(ran == expect, f"{tag} one {SERVE_B}-row request ran {ran} by the "
                                  f"profiler (expected {expect})")
        reg.shutdown()
        self.check(not served.batcher._worker.is_alive(), f"{tag} registry shut down")

    def bert_phase(self, workdir):
        """BERT-base serving at full width: ``Bert.base()`` from its zoo
        seed, bf16 compute over fp32 weights, written to an archive, loaded
        by ``ModelRegistry.load`` and served to 8 client threads sending
        1-64 rows of T=128 token ids. Every answer against the forward built
        from the plain versions; 12 flash launches per batch; masked rows
        against the same rows cut to their tokens; p50 of one 64-row request
        and samples/s."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.models import ModelSerializer
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.serving import ModelRegistry
        from deeplearning4j_tpu_torch.zoo import Bert

        get_environment().allow_bfloat16()
        t0 = time.perf_counter()
        net = Bert.base().init(device=self.device)
        path = os.path.join(workdir, "bert-base.zip")
        ModelSerializer.write_model(net, path)
        del net
        t1 = time.perf_counter()
        reg = ModelRegistry()
        served = reg.load("bert", path, device=self.device, max_batch_size=BERT_B,
                          batch_timeout_ms=5.0)
        log(f"bert: init + write_model {t1 - t0:.1f} s ({os.path.getsize(path) / 1e6:.0f} MB "
            f"archive), ModelRegistry.load {time.perf_counter() - t1:.1f} s")
        rng = np.random.default_rng(4321)
        rows = rng.integers(1, BERT_B + 1, (CLIENTS, REQUESTS_PER_CLIENT))
        rows[0, 0], rows[1, 0] = 1, BERT_B
        reqs = [[rng.integers(0, BERT_VOCAB, (int(n), BERT_T)) for n in r] for r in rows]
        answers = [[None] * REQUESTS_PER_CLIENT for _ in range(CLIENTS)]
        lat, errors = [], []
        lat_lock = threading.Lock()

        def client(c):
            try:
                for k, x in enumerate(reqs[c]):
                    t_req = time.perf_counter()
                    answers[c][k] = reg.predict("bert", x)
                    with lat_lock:
                        lat.append(time.perf_counter() - t_req)
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,), name=f"smoke-bert-{c}")
                   for c in range(CLIENTS)]
        counters = all_counters()
        # ---- the main path: counts from 0 just before, read just after
        torch.cuda.synchronize()
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {c.name: c.value for c in counters}
        # ----
        batches = served.batcher.batches
        self.check(not errors, f"bert serving: {len(lat)} requests answered, errors={errors}")
        want = {c.name: 0 for c in counters}
        want[fa.counter.name] = BERT_LAYERS * batches
        self.check(counts == want, f"bert launch counts over the serving run: {counts} "
                                   f"(expected {BERT_LAYERS} layers x {batches} batches of "
                                   f"{fa.counter.name}, nothing else)")
        self.add_launches({fa.counter.name: counts[fa.counter.name]})
        model = served.model
        worst = 0.0
        with plain_attention():
            for c in range(CLIENTS):
                for k, x in enumerate(reqs[c]):
                    got, n = answers[c][k], x.shape[0]
                    bucket = next(b for b in served.batcher.buckets if b >= n)
                    padded = np.zeros((bucket, BERT_T), x.dtype)
                    padded[:n] = x
                    want_p = model.output(padded).float().cpu().numpy()[:n]
                    ok = got is not None and got.shape == (n, 2) and bool(np.isfinite(got).all())
                    worst = max(worst, float(np.abs(got - want_p).max()) if ok else float("inf"))
        self.check(worst <= BERT_TOL,
                   f"bert {CLIENTS * REQUESTS_PER_CLIENT} served answers vs plain forward: "
                   f"max_abs_err={worst:.3g} tol={BERT_TOL:g}")
        total_rows = int(rows.sum())
        lat_ms = sorted(1e3 * v for v in lat)
        log(f"bert serving: {len(lat)} requests, {total_rows} rows x {BERT_T} tokens in "
            f"{wall:.3f} s over {batches} batches (buckets {served.batcher.bucket_counts}); "
            f"latency p50 {lat_ms[len(lat_ms) // 2]:.2f} ms, max {lat_ms[-1]:.2f} ms; "
            f"{total_rows / wall:.0f} samples/s")

        # masked rows == the same rows cut to their tokens
        lengths = [1, 2, 7, 31, 64, 100, 127, BERT_T]
        x = reqs[1][0][:len(lengths)]
        m = (np.arange(BERT_T)[None, :] < np.array(lengths)[:, None]).astype(np.float32)
        before = fa.counter.value
        full = model.output(x, mask=m).float().cpu().numpy()
        err = max(float(np.abs(full[i] - model.output(x[i:i + 1, :n]).float().cpu().numpy()[0])
                        .max()) for i, n in enumerate(lengths))
        launched = fa.counter.value - before
        self.check(err <= BERT_TOL and launched == BERT_LAYERS * (1 + len(lengths)),
                   f"bert masked output vs rows cut to lengths {lengths}: max_abs_err={err:.3g} "
                   f"tol={BERT_TOL:g}; {launched} launches (expected "
                   f"{BERT_LAYERS * (1 + len(lengths))})")

        # one full-bucket request at a time: latency and samples/s
        x = reqs[1][0]  # BERT_B rows
        reg.predict("bert", x)  # warm-up
        ms = []
        for _ in range(20):
            t_req = time.perf_counter()
            reg.predict("bert", x)
            ms.append(1e3 * (time.perf_counter() - t_req))
        ms.sort()
        self.bert_p50_ms = ms[len(ms) // 2]
        log(f"bert one {BERT_B}-row T={BERT_T} request at a time, {len(ms)} requests: p50 "
            f"{self.bert_p50_ms:.2f} ms (min {ms[0]:.2f}, max {ms[-1]:.2f}), "
            f"{BERT_B / self.bert_p50_ms * 1e3:.0f} samples/s at p50")
        self.device_breakdown(lambda: model.output(x), f"bert {BERT_B}-row output")
        reg.shutdown()
        self.check(not served.batcher._worker.is_alive(), "bert registry shut down")

    def resnet_phase(self, workdir):
        """ResNet-50 trained by ``fit`` as bench_resnet trains it (batch 256
        at 224x224, bf16 compute over fp32 weights, Nesterovs(0.1, 0.9), one
        synthetic batch repeated): the main path, counted, 36 conv_stats
        launches a step and nothing else; step ms, img/s, peak memory, a
        device-busy breakdown; the loss falls and every BatchNormalization's
        running statistics move; the first steps against the same net with
        conv_stats' plain version. Then the trained net through an archive
        and ``ModelRegistry``: p50 of 20 sequential 64-row requests, answers
        against the net's own output."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.models import ComputationGraph
        from deeplearning4j_tpu_torch.ops.kernels import conv_stats as cs
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.serving import ModelRegistry
        from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
        from deeplearning4j_tpu_torch.train.updaters import Nesterovs
        from deeplearning4j_tpu_torch.zoo import ResNet50
        get_environment().allow_bfloat16()
        torch.cuda.empty_cache()
        zoo = ResNet50(num_classes=RESNET_CLASSES, height=RESNET_HW, width=RESNET_HW,
                       updater=Nesterovs(0.1, momentum=0.9))
        t0 = time.perf_counter()
        net = zoo.init(device=self.device)
        torch.cuda.synchronize()
        pairs = net.fused_pairs
        log(f"resnet: ResNet50 init {time.perf_counter() - t0:.1f} s, {net.num_params()} "
            f"parameters, {len(net.conf.nodes)} nodes, {len(pairs)} fused 1x1 conv + "
            f"BatchNormalization pairs")
        self.check(len(pairs) == RESNET_PAIRS, f"resnet fused pairs: {len(pairs)} (expected "
                                               f"{RESNET_PAIRS}): {sorted(pairs)}")
        g = torch.Generator(device=self.device).manual_seed(0)
        x = torch.randn(RESNET_B, RESNET_HW, RESNET_HW, 3, generator=g,
                        device=self.device).to(torch.bfloat16)
        labels = torch.randint(0, RESNET_CLASSES, (RESNET_B,), generator=g, device=self.device)
        y = torch.nn.functional.one_hot(labels, RESNET_CLASSES).float()
        state0 = clone_tree(net._model_state)
        snaps = []  # (params, state) before each of the first RESNET_CMP_STEPS steps
        scores, stamps = CollectScoresListener(), []
        net.set_listeners(scores, StepStamps(stamps))
        counters = all_counters()

        # ---- the main path: counts from 0 just before, read just after
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        for i in range(RESNET_STEPS):
            if i < RESNET_CMP_STEPS:
                snaps.append((clone_tree(net.params()), clone_tree(net._model_state)))
            net.fit(x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {c.name: c.value for c in counters}
        # ----
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = {c.name: 0 for c in counters}
        want[cs.counter.name] = RESNET_PAIRS * RESNET_STEPS
        self.check(counts == want, f"resnet fit launch counts over {RESNET_STEPS} steps: "
                                   f"{counts} (expected {RESNET_PAIRS} conv_stats a step from "
                                   "fit itself, nothing else)")
        self.add_launches({cs.counter.name: counts[cs.counter.name]})
        losses = [v for _, v in scores.scores]
        tail = sum(losses[-3:]) / 3
        self.check(len(losses) == RESNET_STEPS and all(np.isfinite(v) for v in losses)
                   and tail < losses[0],
                   f"resnet bf16 loss on the repeated batch: first {losses[0]:.4f}, mean of the "
                   f"last 3 {tail:.4f} (must be below the first): "
                   + " ".join(f"{v:.4f}" for v in losses))
        moved = {name: max(float((net._model_state[name][k] - st[k]).abs().max())
                           for k in ("mean", "var")) for name, st in state0.items()}
        still = sorted(n for n, v in moved.items() if not v > 0.0)
        self.check(not still, f"resnet running statistics of all {len(moved)} "
                              f"BatchNormalizations moved over {RESNET_STEPS} steps (least "
                              f"max |change| {min(moved.values()):.3g}, stem_bn "
                              f"{moved['stem_bn']:.3g}, s3b1_b1 {moved['s3b1_b1']:.3g}); "
                              f"unmoved: {still}")
        step_ms = sorted(1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
        med = step_ms[len(step_ms) // 2]
        self.resnet_step_ms = med
        log(f"resnet train: {RESNET_STEPS} steps of batch {RESNET_B} at {RESNET_HW}x{RESNET_HW} "
            f"bf16 in {wall:.3f} s; step ms after the first: median {med:.2f} (min "
            f"{step_ms[0]:.2f}, max {step_ms[-1]:.2f}); {RESNET_B / med * 1e3:.1f} img/s at the "
            f"median; first step {1e3 * (stamps[0] - t0):.1f} ms; peak memory {peak:.2f} GiB")
        net.set_listeners()
        per = self.device_breakdown(lambda: net.fit(x, y), f"resnet fit step (batch {RESNET_B})",
                                    reps=3, step_ms=med)
        for _ in range(3):  # a session that lost a launch is taken again
            new, old, ms = self.conv_stats_in(per)
            if new == RESNET_PAIRS and old == 0:
                break
            per, _ = self.profile_kernels(lambda: net.fit(x, y), 1)
        self.check(new == RESNET_PAIRS and old == 0,
                   f"resnet fit step: the profiler sees {new:g} conv_stats_wgmma_kernel and "
                   f"{old:g} conv_stats_kernel launches a step (expected {RESNET_PAIRS} and 0)")
        self.resnet_conv_stats_ms = ms
        log(f"resnet fit step: conv_stats (tile and column-sum kernels) {ms:.3f} ms of the "
            "step's device time (profiler)")

        # ---- serving: the trained net through an archive and the registry
        path = os.path.join(workdir, "resnet50.zip")
        t0 = time.perf_counter()
        net.save(path)
        t1 = time.perf_counter()
        reg = ModelRegistry()
        served = reg.load("resnet", path, device=self.device, max_batch_size=RESNET_SERVE_B)
        log(f"resnet: save {t1 - t0:.1f} s ({os.path.getsize(path) / 1e6:.0f} MB archive), "
            f"ModelRegistry.load {time.perf_counter() - t1:.1f} s")
        rng = np.random.default_rng(11)
        reqs = [rng.normal(0, 1, (RESNET_SERVE_B, RESNET_HW, RESNET_HW, 3)).astype(np.float32)
                for _ in range(4)]
        reg.predict("resnet", reqs[0])  # warm-up
        for c in counters:
            c.reset()
        ms, answers = [], []
        for i in range(20):
            t_req = time.perf_counter()
            answers.append(reg.predict("resnet", reqs[i % len(reqs)]))
            ms.append(1e3 * (time.perf_counter() - t_req))
        counts = {c.name: c.value for c in counters}
        ms.sort()
        p50 = ms[len(ms) // 2]
        log(f"resnet serving (bf16): 20 sequential {RESNET_SERVE_B}-row requests: p50 "
            f"{p50:.2f} ms (min {ms[0]:.2f}, max {ms[-1]:.2f}), "
            f"{RESNET_SERVE_B / p50 * 1e3:.1f} img/s at p50")
        self.check(all(v == 0 for v in counts.values()),
                   f"resnet serving launches nothing of the port (inference runs the pairs "
                   f"unfused): {counts}")
        with torch.inference_mode():
            own = [net.output(r).float().cpu().numpy() for r in reqs]
        err = max(float(np.abs(a - own[i % len(reqs)]).max()) for i, a in enumerate(answers))
        top = np.sort(np.concatenate([a.max(1) for a in answers[:len(reqs)]]))
        self.check(err <= RESNET_SERVE_TOL and all(a.shape == (RESNET_SERVE_B, RESNET_CLASSES)
                                                   for a in answers),
                   f"resnet 20 answers served from the archive vs the trained net's own "
                   f"output: max_abs_err={err:.3g} on probabilities, tol={RESNET_SERVE_TOL:g}; "
                   f"top probability min {top[0]:.4f}, median {top[len(top) // 2]:.4f}, max "
                   f"{top[-1]:.4f}")
        reg.shutdown()
        self.check(not served.batcher._worker.is_alive(), "resnet registry shut down")
        del net, served, reg
        torch.cuda.empty_cache()

        # ---- the kernel vs the plain version, at the weights of each of the
        # first RESNET_CMP_STEPS steps
        plain = ComputationGraph(zoo.conf(), device=self.device).init(params=snaps[0][0])
        plain_scores = CollectScoresListener()
        plain.set_listeners(plain_scores)
        with plain_conv_stats():
            for params, state in snaps:
                plain.set_params(params)
                plain._model_state = state
                plain.fit(x, y)
        want_l = [v for _, v in plain_scores.scores]
        got = losses[:RESNET_CMP_STEPS]
        err = max(abs(a - b) for a, b in zip(got, want_l))
        self.check(err <= RESNET_TOL,
                   f"resnet bf16 losses of the first {RESNET_CMP_STEPS} steps, kernel "
                   f"{' '.join(f'{v:.5f}' for v in got)} vs plain conv_stats from the same "
                   f"weights {' '.join(f'{v:.5f}' for v in want_l)}: max_abs_err={err:.3g} "
                   f"tol={RESNET_TOL:g}")
        del plain, snaps, state0, x, y
        torch.cuda.empty_cache()

    @staticmethod
    def conv_stats_in(per):
        """From a ``profile_kernels`` table: launches a call of the wgmma
        conv_stats kernel and of the other one, and the device ms a call of
        both and of the column sums."""
        new = sum(n for k, (_, n) in per.items() if "conv_stats_wgmma_kernel" in k)
        old = sum(n for k, (_, n) in per.items() if "conv_stats_kernel<" in k)
        ms = sum(t for k, (t, _) in per.items() if "conv_stats" in k or "column_sums_kernel" in k)
        return new, old, ms

    def recurrent_kernels(self, fn, expect, reps=3, tries=8, pattern=RECURRENT_KERNEL):
        """The kernels matching ``pattern`` (default the recurrent ones,
        ``RECURRENT_KERNEL``) one call of ``fn`` launches, by the profiler's
        names: ``{name: launches per call}`` over ``reps`` calls, to be held
        against ``expect``. A
        session can lose kernel records, never add one (one saw one of a
        request's two launches: over 3 calls that reads 5/3, not 1; one saw
        none of a check's three launches; a loss of whole calls' records
        reads as a smaller whole count). So a session that saw fewer
        launches of the expected kernels and nothing else is taken again,
        up to ``tries`` times; a kernel not in ``expect``, or more launches
        than it says, ends the search at once."""
        lossy = []
        for _ in range(tries):
            per, _ = self.profile_kernels(fn, reps)
            ran = {}
            for key, (_, n) in per.items():
                m = pattern.search(key)
                if m:
                    ran[m[1]] = ran.get(m[1], 0) + n
            ran = {k: int(n) if float(n).is_integer() else n for k, n in sorted(ran.items())}
            if ran == expect or any(k not in expect or n > expect[k] for k, n in ran.items()):
                break
            lossy.append(ran)
        if lossy:
            log(f"profiler: {len(lossy)} session(s) lost kernel records (they saw {lossy} a "
                f"call); the one used saw {ran}")
        return ran

    def profile_kernels(self, fn, reps):
        """``torch.profiler`` over ``reps`` calls of ``fn`` (after one
        warm-up call): ``{kernel name: (device ms per call, launches per
        call)}`` (launches a float: a session that lost events shows a
        fraction) and the host wall ms per call under the profiler. The
        session makes PROFILE_PAD_LAUNCHES empty launches before the first
        call and after the last, outside the counts, for the records a
        session late in a long run loses."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PAD_LAUNCHES):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
            for _ in range(PROFILE_PAD_LAUNCHES):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            if str(e.device_type).endswith("CUDA") and "spin_kernel" not in e.key:
                dev = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                per[e.key] = (dev / 1e3 / reps, e.count / reps)
        return per, wall

    def device_ms(self, fn, match=None, reps=20):
        """Device milliseconds per call of ``fn`` from ``torch.profiler``:
        the kernels whose names hold ``match`` (a string, or a tuple of
        strings any of which a name may hold), or every kernel the call
        launches. A launch shorter than its wrapper's host time is timed
        by its own device time, not by back-to-back CUDA events, which
        then measure the host. A profile that came back with no device
        event at all, or that lost some (a kernel seen a fractional number
        of times a call, or none of ``match``), is taken again, up to 3
        times; after that the whole call is timed by ``queued_ms`` (its
        gaps included), and the log says so."""
        what = match or "the call"
        names = (match,) if isinstance(match, str) else match
        for _ in range(3):
            per, _ = self.profile_kernels(fn, reps)
            ms = sum(t for name, (t, _) in per.items()
                     if names is None or any(m in name for m in names))
            if ms > 0 and all(float(n).is_integer() for _, n in per.values()):
                return ms
        ms = queued_ms(fn, reps)
        log(f"device time of {what}: three profiler sessions lost events (the last saw "
            f"{ {k[:60]: n for k, (_, n) in per.items()} } a call); the time given for it below "
            f"is by CUDA events with the card held while the host queues the calls: {ms:.4f} ms")
        return ms

    def device_breakdown(self, fn, what, reps=5, step_ms=None):
        """Device busy time per call of ``fn`` (the sum of its kernels'
        device time, so idle gaps between kernels are not in it), the
        kernels that take most of it, and the busy share of the host wall
        time of the same calls under the profiler (whose own host cost is
        in that wall time) and, given ``step_ms``, of that wall time
        measured without the profiler."""
        per, wall = self.profile_kernels(fn, reps)
        busy = sum(ms for ms, _ in per.values())
        if busy <= 0:
            log(f"{what}: the profiler saw no device time (not measured)")
            return per
        top = sorted(per.items(), key=lambda kv: kv[1][0], reverse=True)[:8]
        share = "" if step_ms is None else \
            f"; busy {100 * busy / step_ms:.0f}% of the {step_ms:.2f} ms step measured without it"
        log(f"{what}: device busy {busy:.3f} ms per call over {reps} calls, "
            f"{sum(n for _, n in per.values()):g} kernels per call; host wall under the "
            f"profiler {wall:.3f} ms per call (busy {100 * busy / wall:.0f}%){share}; top kernels: "
            + "; ".join(f"{k[:60]} {ms:.3f} ms x{n:g}" for k, (ms, n) in top))
        return per

    def ffn_elementwise_ms(self, fn, width):
        """Device ms of one call of ``fn`` spent in aten ops other than
        products whose inputs include a tensor ``width`` wide in its last
        dimension, and the device ms of all its ops (``torch.profiler`` with
        input shapes, each op's own kernels)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            fn()
            torch.cuda.synchronize()
        wide = busy = 0.0
        for e in prof.key_averages(group_by_input_shape=True):
            if str(e.device_type).endswith("CUDA"):
                continue
            dev = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3
            busy += dev
            product = any(k in e.key for k in ("mm", "matmul", "linear", "einsum"))
            if not product and any(s and s[-1] == width for s in (e.input_shapes or [])):
                wide += dev
        return wide, busy

    def train_phase(self, cell):
        """``fit`` of the full-width char-RNN of ``cell`` in bf16 through the
        kernels (the main path, counted), then the first steps again in
        float32 and bfloat16 against a trainer built from the plain
        versions."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
        from deeplearning4j_tpu_torch.models import MultiLayerNetwork
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
        env = get_environment()
        kernel = self.cell_module(CHAR_RNN_KERNELS[cell])
        tag = CHAR_RNN_TAGS[cell]
        conf = lambda: char_rnn_conf(cell, TRAIN_T)  # noqa: E731
        init = MultiLayerNetwork(conf(), device=self.device).init().params()
        batches = char_batches(TRAIN_STEPS, seed=77 + CHAR_RNN_SEEDS[cell])
        counters = all_counters()

        def fit(steps, dtype):
            env.set_compute_dtype(dtype)
            net = MultiLayerNetwork(conf(), device=self.device).init(params=clone_tree(init))
            scores, stamps = CollectScoresListener(), []
            net.set_listeners(scores, StepStamps(stamps))
            net.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches[:steps]]))
            return [v for _, v in scores.scores], stamps

        # ---- the main path: counts from 0 just before, read just after
        torch.cuda.synchronize()
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        losses, stamps = fit(TRAIN_STEPS, torch.bfloat16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {c.name: c.value for c in counters}
        # ----
        want = {c.name: 0 for c in counters}
        want[kernel.save_counter.name] = want[kernel.bwd_counter.name] = LAYERS * TRAIN_STEPS
        self.check(counts == want, f"{tag} train launch counts over {TRAIN_STEPS} steps: "
                                   f"{counts} (expected {want})")
        self.add_launches({c.name: counts[c.name]
                           for c in (kernel.save_counter, kernel.bwd_counter)})
        finite = all(np.isfinite(v) for v in losses)
        tail = sum(losses[-3:]) / 3
        self.check(finite and len(losses) == TRAIN_STEPS and tail < LOSS_FALL * losses[0],
                   f"{tag} bf16 loss {losses[0]:.4f} -> mean of the last 3 {tail:.4f} over "
                   f"{len(losses)} steps (must fall below {LOSS_FALL} x the first): "
                   + " ".join(f"{v:.4f}" for v in losses))
        step_ms = sorted(1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
        med = step_ms[len(step_ms) // 2]
        self.train_step_ms[cell] = med
        log(f"{tag} train: {TRAIN_STEPS} steps of B={TRAIN_B} T={TRAIN_T} in {wall:.3f} s; "
            f"step ms after the first: median {med:.2f} (min {step_ms[0]:.2f}, max "
            f"{step_ms[-1]:.2f}); {TRAIN_B * TRAIN_T / med * 1e3:.0f} tokens/s at the median; "
            f"first step {1e3 * (stamps[0] - t0):.1f} ms")
        expect = {k: LAYERS for k in CHAR_RNN_RAN[cell]}
        ran = self.recurrent_kernels(lambda: fit(1, torch.bfloat16), expect)
        self.check(ran == expect, f"{tag} one bf16 training step ran {ran} by the profiler "
                                  f"(expected {expect})")

        # ---- kernels vs the plain trainer, the first CMP_STEPS steps
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            got = losses[:CMP_STEPS] if dtype == torch.bfloat16 else fit(CMP_STEPS, dtype)[0]
            with plain_recurrences():
                want_l = fit(CMP_STEPS, dtype)[0]
            err = max(abs(a - b) for a, b in zip(got, want_l))
            self.check(err <= TRAIN_TOL[dname],
                       f"{tag} {dname} first {CMP_STEPS} losses, kernels "
                       f"{' '.join(f'{v:.5f}' for v in got)} vs plain "
                       f"{' '.join(f'{v:.5f}' for v in want_l)}: max_abs_err={err:.3g} "
                       f"tol={TRAIN_TOL[dname]:g}")
        env.allow_bfloat16()

    def bert_train_phase(self):
        """``fit`` of ``Bert.base()`` at bench_zoo_bert's step (B=64, T=128,
        an all-ones features mask, Adam(2e-5), dropout 0.1, bf16 compute
        over fp32 weights, random ids) through the kernels: the main path,
        counted. Then a device-busy breakdown of one step, the first steps
        again in float32 and bfloat16 against a trainer whose attention runs
        the plain versions, a fit on labels the net can learn in 20 steps,
        and the statistics of the dropout masks the card draws."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.nn.base import keep_mask
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.zoo import Bert
        env = get_environment()
        t0 = time.perf_counter()
        init = Bert.base().init(device=self.device).params()
        torch.cuda.synchronize()
        log(f"bert train: Bert.base() init {time.perf_counter() - t0:.1f} s")
        batches = label_batches(BERT_TRAIN_STEPS, 99, random_ids)
        fmask = np.ones((BERT_B, BERT_T), np.float32)
        counters = all_counters()

        # ---- the main path: counts from 0 just before, read just after
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        losses, stamps, net = self.bert_fit(init, batches, torch.bfloat16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {c.name: c.value for c in counters}
        # ----
        want = {c.name: 0 for c in counters}
        for c in (fa.lse_counter, fa.bwd_dq_counter, fa.bwd_dkv_counter):
            want[c.name] = BERT_LAYERS * BERT_TRAIN_STEPS
            self.add_launches({c.name: counts[c.name]})
        self.check(counts == want, f"bert train launch counts over {BERT_TRAIN_STEPS} steps: "
                                   f"{counts} (expected {want})")
        finite = all(np.isfinite(v) for v in losses) and len(losses) == BERT_TRAIN_STEPS
        step_ms = sorted(1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
        med = step_ms[len(step_ms) // 2]
        self.bert_train_step_ms = med
        log(f"bert train: {BERT_TRAIN_STEPS} steps of B={BERT_B} T={BERT_T} in {wall:.3f} s; "
            f"losses " + " ".join(f"{v:.4f}" for v in losses) + "; "
            f"step ms after the first: median {med:.2f} (min {step_ms[0]:.2f}, max "
            f"{step_ms[-1]:.2f}); {BERT_B / med * 1e3:.0f} samples/s at the median; first step "
            f"{1e3 * (stamps[0] - t0):.1f} ms; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
        x, y = batches[0]
        self.device_breakdown(lambda: net.fit(x, y, mask=fmask), "bert train step", reps=3,
                              step_ms=med)
        del net
        torch.cuda.empty_cache()

        # ---- kernels vs the plain trainer, the first BERT_CMP_STEPS steps
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            got = losses[:BERT_CMP_STEPS] if dtype == torch.bfloat16 else \
                self.bert_fit(init, batches[:BERT_CMP_STEPS], dtype)[0]
            with plain_attention():
                want_l = self.bert_fit(init, batches[:BERT_CMP_STEPS], dtype)[0]
            torch.cuda.empty_cache()
            err = max(abs(a - b) for a, b in zip(got, want_l))
            self.check(err <= BERT_TRAIN_TOL[dname],
                       f"bert train {dname} first {BERT_CMP_STEPS} losses, kernels "
                       f"{' '.join(f'{v:.5f}' for v in got)} vs plain "
                       f"{' '.join(f'{v:.5f}' for v in want_l)}: max_abs_err={err:.3g} "
                       f"tol={BERT_TRAIN_TOL[dname]:g}")

        # ---- learning: a second fit, on every_token's labels
        losses_l, _, net = self.bert_fit(init, label_batches(BERT_TRAIN_STEPS, 99, every_token),
                                         torch.bfloat16)
        tail = sum(losses_l[-3:]) / 3
        limit = BERT_LOSS_FALL * min(losses_l[0], math.log(2))
        acc = self.accuracy(net, label_batches(1, 7, every_token)[0])
        self.check(finite and all(np.isfinite(v) for v in losses_l) and tail < limit
                   and acc >= BERT_MIN_ACC,
                   f"bert train bf16 loss (main path finite over {len(losses)} steps): "
                   f"every_token's first {losses_l[0]:.4f} -> mean of the last 3 {tail:.4f} "
                   f"(must fall below {BERT_LOSS_FALL} x min(first, ln 2) = {limit:.4f}); "
                   f"accuracy on a fresh batch {acc:.3f} (must be >= {BERT_MIN_ACC}): "
                   + " ".join(f"{v:.4f}" for v in losses_l))
        del net
        torch.cuda.empty_cache()
        env.allow_bfloat16()

        # ---- dropout masks drawn on the card: keep share and determinism
        act = torch.ones(BERT_B, BERT_T, 768, device=self.device)
        masks = [keep_mask(act, 0.9, torch.Generator().manual_seed(s)) for s in (5, 5, 6)]
        share = float(masks[0].float().mean())
        self.check(masks[0].device.type == "cuda" and abs(share - 0.9) < 1e-3
                   and bool(torch.equal(masks[0], masks[1]))
                   and not bool(torch.equal(masks[0], masks[2])),
                   f"dropout keep mask on the card: keep share {share:.5f} (expected 0.9 +- "
                   f"1e-3 over {act.numel()} draws), same seed same mask, other seed another")

    def bert_fit(self, init, batches, dtype):
        """``fit`` of ``Bert.base()`` from the parameters ``init`` over
        ``batches`` (all-ones features mask) with ``dtype`` compute: the
        per-step losses, the host clock at each step's end, the network."""
        import numpy as np
        from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
        from deeplearning4j_tpu_torch.models import MultiLayerNetwork
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
        from deeplearning4j_tpu_torch.zoo import Bert
        get_environment().set_compute_dtype(dtype)
        net = MultiLayerNetwork(Bert.base().conf(), device=self.device).init(
            params=clone_tree(init))
        scores, stamps = CollectScoresListener(), []
        net.set_listeners(scores, StepStamps(stamps))
        fmask = np.ones((BERT_B, BERT_T), np.float32)
        net.fit(ListDataSetIterator([DataSet(x, y, features_mask=fmask) for x, y in batches]))
        return [v for _, v in scores.scores], stamps, net

    def accuracy(self, net, batch):
        """Share of ``batch``'s rows whose label ``net`` predicts."""
        import numpy as np
        x, y = batch
        with self.torch.inference_mode():
            out = net.output(x, mask=np.ones(x.shape, np.float32))
        return float((out.float().argmax(1).cpu().numpy() == y.argmax(1)).mean())

    def label_rules_phase(self):
        """BERT_TRAIN_STEPS bf16 steps of ``Bert.base()`` from one init under
        each of LABEL_RULES: the first loss, the mean of the last 3, and the
        trained net's accuracy on a fresh batch of the same rule."""
        from deeplearning4j_tpu_torch.zoo import Bert
        init = Bert.base().init(device=self.device).params()
        for name, rule, prior, repeat in LABEL_RULES:
            batches = label_batches(BERT_TRAIN_STEPS, 99, rule, prior, repeat)
            losses, _, net = self.bert_fit(init, batches, self.torch.bfloat16)
            acc = self.accuracy(net, label_batches(1, 7, rule, prior)[0])
            log(f"label rule '{name}' (prior {prior}): first {losses[0]:.4f}, mean of the "
                f"last 3 {sum(losses[-3:]) / 3:.4f}, accuracy on a fresh batch {acc:.3f}: "
                + " ".join(f"{v:.4f}" for v in losses))
            del net
            self.torch.cuda.empty_cache()
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        get_environment().allow_bfloat16()

    def sd_bert(self, what):
        """BERT-base as the JAX package's TF import yields it
        (``build_bert_samediff``, seed 0), ``optimize()``d (its fusion
        counts checked), a 2-class head grafted, every weight trainable:
        ``(sd, inputs, initial weights, the MultiDataSet of
        bert_synthetic_batch(64, 128, 30522, seed=1))``."""
        from deeplearning4j_tpu_torch.autodiff.graph_optimizer import optimize
        from deeplearning4j_tpu_torch.data import MultiDataSet
        from deeplearning4j_tpu_torch.imports.tf_oracles import (bert_synthetic_batch,
                                                                 build_bert_samediff,
                                                                 graft_classifier)
        t0 = time.perf_counter()
        sd, inputs, _, _ = build_bert_samediff(
            batch=BERT_B, seq_len=BERT_T, hidden=SD_HIDDEN, layers=BERT_LAYERS, heads=SD_HEADS,
            intermediate=SD_FF, vocab=BERT_VOCAB, seed=0, device=self.device)
        n_before = len(sd.ops)
        t1 = time.perf_counter()
        stats = optimize(sd)
        t2 = time.perf_counter()
        want = {"layer_norm": 2 * BERT_LAYERS + 1, "gelu_erf": BERT_LAYERS,
                "attention": BERT_LAYERS}
        got = {k: stats.get(k) for k in want}
        sdpa = [n for n in sd.ops if n.op == "scaled_dot_product_attention"]
        self.check(got == want and all(n.attrs.get("boolean_bias") for n in sdpa),
                   f"{what}: build {t1 - t0:.1f} s ({n_before} ops), optimize() "
                   f"{t2 - t1:.1f} s -> {len(sd.ops)} ops, {stats} (expected {want}, every "
                   f"attention with the padding bias proven: "
                   f"{[bool(n.attrs.get('boolean_bias')) for n in sdpa]})")
        graft_classifier(sd, "pooled_output", hidden=SD_HIDDEN)
        sd.convert_to_variable(*sd.trainable_float_constants())
        sd.set_loss_variables("finetune_loss")
        init = {n: t.detach().clone() for n, t in sd._trainable().items()}
        log(f"{what}: {len(init)} trainable arrays, "
            f"{sum(t.numel() for t in init.values()):,} weights; ops after the graft: "
            f"{sorted({n.op for n in sd.ops})}")
        ids, types, mask, labels = bert_synthetic_batch(BERT_B, BERT_T, BERT_VOCAB, seed=1)
        mds = MultiDataSet(features=[ids, types, mask], labels=[labels])
        return sd, inputs, init, mds

    def samediff_phase(self):
        """BASELINE config #4 as ``bench_imported_bert`` measures it:
        BERT-base built as the JAX package's TF import yields it, through
        ``optimize()`` (25 LayerNorm, 12 gelu and 12 attention fusions, every
        attention with the proven padding bias), ``graft_classifier``,
        ``convert_to_variable`` and ``fit`` over ``ExistingDataSetIterator``
        of MultiDataSets at B=64, T=128, Adam(2e-5), bf16 over fp32 masters:
        the main path, counted (12 saving forwards, 12 dq and 12 dk/dv flash
        launches a step, nothing else). Then step times, a device-busy
        breakdown, the first losses in fp32 and bf16 against the same fit
        with the plain attention, ``sd.output`` against the plain attention
        and its p50, and a fit on labels the net can learn."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.autodiff.samediff import TrainingConfig
        from deeplearning4j_tpu_torch.data import ExistingDataSetIterator, MultiDataSet
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.train.updaters import Adam
        env = get_environment()
        sd, inputs, init, mds = self.sd_bert("samediff bert")
        ids, types, mask = mds.features

        def fit(batches, dtype, lr=2e-5):
            """One epoch over ``batches`` from the initial weights and a
            fresh Adam: the per-step losses and the host clock at each
            step's end."""
            with torch.no_grad():
                for n, t in init.items():
                    sd.arrays[n].copy_(t)
            sd.set_training_config(TrainingConfig(
                updater=Adam(lr), data_set_feature_mapping=list(inputs),
                data_set_label_mapping=["labels"]))
            sd._train_iter = 0
            env.set_compute_dtype(dtype)
            stamps = []
            sd.set_listeners(StepStamps(stamps))
            return list(sd.fit(ExistingDataSetIterator(batches))), stamps

        counters = all_counters()
        # ---- the main path: counts from 0 just before, read just after
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        losses, stamps = fit([mds] * SD_STEPS, torch.bfloat16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {c.name: c.value for c in counters}
        # ----
        want = {c.name: 0 for c in counters}
        for c in (fa.lse_counter, fa.bwd_dq_counter, fa.bwd_dkv_counter):
            want[c.name] = BERT_LAYERS * SD_STEPS
            self.add_launches({c.name: counts[c.name]})
        self.check(counts == want, f"samediff bert launch counts over {SD_STEPS} steps: "
                                   f"{counts} (expected {want})")
        finite = len(losses) == SD_STEPS and all(np.isfinite(v) for v in losses)
        step_ms = sorted(1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
        med = step_ms[len(step_ms) // 2]
        zoo = "not run" if self.bert_train_step_ms is None else \
            f"{self.bert_train_step_ms:.2f} ms"
        log(f"samediff bert train: {SD_STEPS} steps of B={BERT_B} T={BERT_T} in {wall:.3f} s; "
            f"losses first {losses[0]:.4f}, last {losses[-1]:.4f}: "
            + " ".join(f"{v:.4f}" for v in losses) + "; "
            f"step ms after the first: median {med:.2f} (min {step_ms[0]:.2f}, max "
            f"{step_ms[-1]:.2f}); {BERT_B / med * 1e3:.0f} samples/s at the median; first step "
            f"{1e3 * (stamps[0] - t0):.1f} ms; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; the zoo bert train "
            f"phase's median step in this run: {zoo}")
        self.device_breakdown(lambda: sd.fit(ExistingDataSetIterator([mds])),
                              "samediff bert train step", reps=3, step_ms=med)
        wide, busy = self.ffn_elementwise_ms(lambda: sd.fit(ExistingDataSetIterator([mds])),
                                             SD_FF)
        log(f"samediff bert train step: elementwise and reduction ops on (..., {SD_FF}) "
            f"tensors (the FFN's activation; products excluded) {wide:.3f} ms of the "
            f"{busy:.3f} ms its ops launched (torch.profiler, one step, by aten op and "
            f"input shape)")

        # ---- kernels vs the plain attention, the first BERT_CMP_STEPS steps
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            got = losses[:BERT_CMP_STEPS] if dtype == torch.bfloat16 else \
                fit([mds] * BERT_CMP_STEPS, dtype)[0]
            with plain_attention():
                want_l = fit([mds] * BERT_CMP_STEPS, dtype)[0]
            err = max(abs(a - b) for a, b in zip(got, want_l))
            self.check(err <= BERT_TRAIN_TOL[dname],
                       f"samediff bert {dname} first {BERT_CMP_STEPS} losses, kernels "
                       f"{' '.join(f'{v:.5f}' for v in got)} vs plain "
                       f"{' '.join(f'{v:.5f}' for v in want_l)}: max_abs_err={err:.3g} "
                       f"tol={BERT_TRAIN_TOL[dname]:g}")

        # ---- sd.output against the plain attention (fp32), and its p50
        with torch.no_grad():
            for n, t in init.items():
                sd.arrays[n].copy_(t)
        feeds = dict(zip(inputs, [ids, types, mask]))
        before = fa.counter.value
        out = sd.output(feeds, "pooled_output").float()
        launched = fa.counter.value - before
        with plain_attention():
            ref = sd.output(feeds, "pooled_output").float()
        err = float((out - ref).abs().max())
        self.check(tuple(out.shape) == (BERT_B, SD_HIDDEN) and bool(torch.isfinite(out).all())
                   and err <= SD_OUTPUT_TOL and launched == BERT_LAYERS,
                   f"samediff bert sd.output(pooled_output) {tuple(out.shape)} fp32 vs plain "
                   f"attention: max_abs_err={err:.3g} tol={SD_OUTPUT_TOL:g}; {launched} "
                   f"inference launches (expected {BERT_LAYERS})")
        ms = []
        for _ in range(21):
            t_req = time.perf_counter()
            sd.output(feeds, "pooled_output").cpu()
            ms.append(1e3 * (time.perf_counter() - t_req))
        ms = sorted(ms[1:])
        log(f"samediff bert one {BERT_B}-row T={BERT_T} sd.output request at a time (fp32), "
            f"{len(ms)} requests: p50 {ms[len(ms) // 2]:.2f} ms (min {ms[0]:.2f}, max "
            f"{ms[-1]:.2f}), {BERT_B / ms[len(ms) // 2] * 1e3:.0f} samples/s at p50")
        self.device_breakdown(lambda: sd.output(feeds, "pooled_output"),
                              f"samediff bert {BERT_B}-row output")

        # ---- learning: a second fit, on every_token's labels
        def learn_batch(x, y):
            x = x.astype(np.int32)
            return MultiDataSet(features=[x, np.zeros_like(x), np.ones_like(x)], labels=[y])

        losses_l, _ = fit([learn_batch(x, y) for x, y in
                           label_batches(SD_STEPS, 99, every_token)], torch.bfloat16,
                          lr=SD_LEARN_LR)
        x, y = label_batches(1, 7, every_token)[0]
        fresh = learn_batch(x, y)
        logits = sd.output(dict(zip(inputs, fresh.features)), "cls_logits").float()
        acc = float((logits.argmax(1).cpu().numpy() == y.argmax(1)).mean())
        tail = sum(losses_l[-3:]) / 3
        limit = BERT_LOSS_FALL * min(losses_l[0], math.log(2))
        self.check(finite and all(np.isfinite(v) for v in losses_l) and tail < limit
                   and acc >= BERT_MIN_ACC,
                   f"samediff bert bf16 loss (main path finite over {len(losses)} steps): "
                   f"every_token's first {losses_l[0]:.4f} -> mean of the last 3 {tail:.4f} "
                   f"at lr {SD_LEARN_LR:g} (must fall below {BERT_LOSS_FALL} x min(first, "
                   f"ln 2) = {limit:.4f}); accuracy on a fresh batch {acc:.3f} (must be >= "
                   f"{BERT_MIN_ACC}): " + " ".join(f"{v:.4f}" for v in losses_l))
        del sd, init
        torch.cuda.empty_cache()
        env.allow_bfloat16()

    # ------------------------------------------------------------- tf import
    def tf_import_phase(self):
        """BASELINE config #4 by the reference's route: the committed
        BERT-base GraphDef (B=64, T=128, vocab 30522; ``tests/data/``)
        decoded by the port's reader, its weight matrices refilled from
        ``bert_weights(seed=0)``, imported by ``TFGraphMapper`` and
        ``optimize()``d (25 / 12 / 12 fusions, every attention with the
        padding bias proven), the op list and arrays those of
        ``build_bert_samediff(seed=0)``, then ``graft_classifier``,
        ``convert_to_variable`` and ``fit`` at bf16 over fp32 masters under
        Adam(2e-5), TF_STEPS steps: the main path, counted (12 saving
        forwards, 12 dq and 12 dk/dv flash launches a step, nothing else),
        the first 3 losses bit for bit those of the builder route from the
        same weights; step ms, samples/s, peak memory, and the import's wall
        time split into decode, refill, import and optimize."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.autodiff.graph_optimizer import optimize
        from deeplearning4j_tpu_torch.autodiff.samediff import TrainingConfig
        from deeplearning4j_tpu_torch.data import ExistingDataSetIterator, MultiDataSet
        from deeplearning4j_tpu_torch.imports import TFGraphMapper
        from deeplearning4j_tpu_torch.imports.graphdef_proto import read_graph_def
        from deeplearning4j_tpu_torch.imports.tf_oracles import (bert_synthetic_batch,
                                                                 bert_weights,
                                                                 build_bert_samediff,
                                                                 graft_classifier,
                                                                 refill_bert_graphdef)
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.train.updaters import Adam
        env = get_environment()
        t0 = time.perf_counter()
        with open(TF_FIXTURE_SIDECAR) as f:
            side = json.load(f)
        gd = read_graph_def(TF_FIXTURE)
        t1 = time.perf_counter()
        cfg = side["config"]
        weights = bert_weights(cfg["seq_len"], cfg["hidden"], cfg["layers"],
                               cfg["intermediate"], cfg["vocab"], cfg["type_vocab"], cfg["seed"])
        refill_bert_graphdef(gd, side["refill"], weights)
        t2 = time.perf_counter()
        sd = TFGraphMapper.import_graph(gd, optimize=False, device=self.device)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        n_nodes, n_ops = len(gd.node), len(sd.ops)
        del gd, weights
        ref, inputs, _, _ = build_bert_samediff(
            batch=cfg["batch"], seq_len=cfg["seq_len"], hidden=cfg["hidden"],
            layers=cfg["layers"], heads=cfg["heads"], intermediate=cfg["intermediate"],
            vocab=cfg["vocab"], seed=cfg["seed"], device=self.device)

        def op_list(g):
            return [(n.op, n.inputs, n.outputs, n.attrs) for n in g.ops]

        same = (op_list(sd) == op_list(ref) and list(sd.vars) == list(ref.vars)
                and sorted(sd.arrays) == sorted(ref.arrays)
                and all(torch.equal(sd.arrays[n], a) for n, a in ref.arrays.items()))
        self.check(same and side["inputs"] == list(inputs),
                   f"tf import: {n_nodes} GraphDef nodes -> {n_ops} ops; op list, variables "
                   f"and arrays those of build_bert_samediff(seed=0): {same}")
        t4 = time.perf_counter()
        stats = optimize(sd)
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        ref_stats = optimize(ref)
        want = {"layer_norm": 2 * cfg["layers"] + 1, "gelu_erf": cfg["layers"],
                "attention": cfg["layers"]}
        got = {k: stats.get(k) for k in want}
        sdpa = [n for n in sd.ops if n.op == "scaled_dot_product_attention"]
        self.check(got == want and stats == ref_stats and op_list(sd) == op_list(ref)
                   and all(n.attrs.get("boolean_bias") for n in sdpa),
                   f"tf import: optimize() -> {len(sd.ops)} ops, {stats} (expected {want}, the "
                   f"builder's {ref_stats}, every attention with the padding bias proven: "
                   f"{[bool(n.attrs.get('boolean_bias')) for n in sdpa]})")
        log(f"tf import wall time: decode {t1 - t0:.3f} s ({os.path.getsize(TF_FIXTURE)} "
            f"bytes), refill {t2 - t1:.3f} s ({len(side['refill'])} matrices from "
            f"bert_weights), import {t3 - t2:.3f} s, optimize {t5 - t4:.3f} s; {self.card}")
        for g in (sd, ref):
            graft_classifier(g, "pooled_output", hidden=cfg["hidden"])
            g.convert_to_variable(*g.trainable_float_constants())
            g.set_loss_variables("finetune_loss")
        init = {n: t.detach().clone() for n, t in sd._trainable().items()}
        self.check(sorted(init) == sorted(ref._trainable()) and all(
            torch.equal(ref.arrays[n], t) for n, t in init.items()),
            f"tf import: {len(init)} trainable arrays, "
            f"{sum(t.numel() for t in init.values()):,} weights, the builder route's")
        ids, types, mask, labels = bert_synthetic_batch(cfg["batch"], cfg["seq_len"],
                                                        cfg["vocab"], seed=1)
        mds = MultiDataSet(features=[ids, types, mask], labels=[labels])

        def fit(g, steps):
            with torch.no_grad():
                for n, t in init.items():
                    g.arrays[n].copy_(t)
            g.set_training_config(TrainingConfig(
                updater=Adam(TF_LR), data_set_feature_mapping=list(inputs),
                data_set_label_mapping=["labels"]))
            g._train_iter = 0
            env.set_compute_dtype(torch.bfloat16)
            stamps = []
            g.set_listeners(StepStamps(stamps))
            return list(g.fit(ExistingDataSetIterator([mds] * steps))), stamps

        counters = all_counters()
        # ---- the main path: counts from 0 just before, read just after
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        losses, stamps = fit(sd, TF_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {c.name: c.value for c in counters}
        # ----
        want = {c.name: 0 for c in counters}
        for c in (fa.lse_counter, fa.bwd_dq_counter, fa.bwd_dkv_counter):
            want[c.name] = cfg["layers"] * TF_STEPS
        self.add_launches(counts)
        self.check(counts == want, f"tf import launch counts over {TF_STEPS} steps: {counts} "
                                   f"(expected {want})")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        step_ms = sorted(1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
        med = step_ms[len(step_ms) // 2]
        finite = len(losses) == TF_STEPS and all(np.isfinite(v) for v in losses)
        log(f"tf import fine-tune: {TF_STEPS} steps of B={cfg['batch']} T={cfg['seq_len']} "
            f"bf16 in {wall:.3f} s; losses " + " ".join(f"{v:.4f}" for v in losses)
            + f"; step ms over the {len(step_ms)} after the first: median {med:.2f} (min "
            f"{step_ms[0]:.2f}, max {step_ms[-1]:.2f}); {cfg['batch'] / med * 1e3:.0f} "
            f"samples/s at the median; first step {1e3 * (stamps[0] - t0):.1f} ms; peak "
            f"device memory {peak:.2f} GiB; {self.card}")
        ref_losses, _ = fit(ref, TF_CMP_STEPS)
        self.check(finite and losses[:TF_CMP_STEPS] == ref_losses,
                   f"tf import first {TF_CMP_STEPS} losses bit for bit the builder route's: "
                   + " ".join(repr(v) for v in losses[:TF_CMP_STEPS]) + " vs "
                   + " ".join(repr(v) for v in ref_losses))
        del sd, ref, init
        torch.cuda.empty_cache()
        env.allow_bfloat16()
        self.tf_import_draws()

    def tf_import_draws(self):
        """The importer's seeded draws on the card with no executor key, as
        ``output()`` runs them: each is drawn there, from a generator on the
        card seeded with the op's seed (the op's numbers are that
        generator's own draw), the same seed gives the same draw, and each
        holds its law as tests/test_torch_tf_ops.py holds it on the CPU:
        mean within 5 sigma, spread within 3% (truncated normal: 0.02 of
        0.8796), range; class frequencies within 0.03."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.autodiff import ops_registry as ops
        dev = torch.device(self.device)
        shape, n = [100, 200], 20000

        def gen(seed):
            return torch.Generator(device=dev).manual_seed(seed)

        def trunc(g):
            t = torch.empty(shape, device=dev)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
            return t

        laws = {"random_uniform": (lambda g: torch.rand(shape, generator=g, device=dev),
                                   0.5, (1 / 12) ** 0.5, 0.03 * (1 / 12) ** 0.5, (0.0, 1.0)),
                "random_normal": (lambda g: torch.randn(shape, generator=g, device=dev),
                                  0.0, 1.0, 0.03, None),
                "truncated_normal": (trunc, 0.0, 0.8796, 0.02, (-2.0, 2.0))}
        for name, (own, mean, std, std_tol, bounds) in laws.items():
            a = ops.get_op(name)(shape=shape, seed=7)
            there = a.device.type == dev.type and torch.equal(a, own(gen(7)))
            same = torch.equal(a, ops.get_op(name)(shape=shape, seed=7))
            other = not torch.equal(a, ops.get_op(name)(shape=shape, seed=8))
            x = a.double()
            m, sd, lo, hi = float(x.mean()), float(x.std()), float(x.min()), float(x.max())
            inside = bounds is None or (bounds[0] <= lo and hi <= bounds[1])
            self.check(there and same and other and inside
                       and abs(m - mean) < 5 * std / n ** 0.5 and abs(sd - std) < std_tol,
                       f"tf import draws: {name} {tuple(a.shape)} on {a.device}, the card "
                       f"generator's own draw {there}, same seed same draw {same}, another "
                       f"seed another {other}; mean {m:.5f} (law {mean}), std {sd:.5f} (law "
                       f"{std:.4f}), range [{lo:.4f}, {hi:.4f}]")
        probs = np.array([[0.1, 0.6, 0.3], [0.5, 0.25, 0.25]], np.float32)
        logits = torch.as_tensor(np.log(probs), device=dev)
        got = ops.get_op("random_categorical")(logits, num_samples=6000, seed=3)
        own = torch.multinomial(torch.softmax(logits, -1), 6000, replacement=True,
                                generator=gen(3)).to(torch.int32)
        freq = np.stack([np.bincount(r, minlength=3) / 6000 for r in got.cpu().numpy()])
        self.check(got.device.type == dev.type and torch.equal(got, own)
                   and float(np.abs(freq - probs).max()) < 0.03,
                   f"tf import draws: random_categorical {tuple(got.shape)} on {got.device}, "
                   f"the card generator's own draw {torch.equal(got, own)}; class frequencies "
                   f"{np.round(freq, 4).tolist()} (law {probs.tolist()})")

    # --------------------------------------------------------------- solvers
    def solvers_phase(self, workdir):
        """The line-search solvers on the card, fp32 with TF32 off: the zoo
        LeNet on MnistDataSetIterator(64)'s first SOLVER_LENET_BATCHES
        batches under each of LBFGS, CONJUGATE_GRADIENT and
        LINE_GRADIENT_DESCENT (layer 0 frozen); the GravesLSTM char-RNN
        (2x512, B=64, T=TRAIN_T, full-sequence BPTT, output layer
        frozen) under LINE_GRADIENT_DESCENT and the LSTM char-RNN built as a
        ComputationGraph under CONJUGATE_GRADIENT, SOLVER_RNN_BATCHES
        batches each. Each run is a main path, counted: the recurrent
        kernels launch their saving forward and backward once per layer in
        every value-and-gradient evaluation and the inference forward once
        per layer in each batch's final forward. The loss falls, frozen
        layers stay bit for bit, and the first batch's values are within
        SOLVER_CPU_TOL of the port's CPU run from the same archive (oneDNN
        off): LeNet's through its final loss, the char-RNNs' through their
        first SOLVER_RNN_CPU_ITERS iterations; batch ms, evaluations and the
        accepted steps of card and CPU are logged."""
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        env = get_environment()
        saved = env.compute_dtype
        env.set_compute_dtype("float32")
        try:
            self._solvers(workdir)
        finally:
            env.set_compute_dtype(saved)

    def _solvers(self, workdir):
        import dataclasses
        torch = self.torch
        from deeplearning4j_tpu_torch.data import MnistDataSetIterator, NumpyDataSetIterator
        from deeplearning4j_tpu_torch.models import ComputationGraph, MultiLayerNetwork
        from deeplearning4j_tpu_torch.models.computation_graph import GraphBuilder
        from deeplearning4j_tpu_torch.nn import InputType, Layer
        from deeplearning4j_tpu_torch.ops.kernels import fused_lstm, fused_lstm_graves
        from deeplearning4j_tpu_torch.zoo import LeNet
        train = MnistDataSetIterator(LENET_B, train=True)
        it = NumpyDataSetIterator(train.features, train.labels, LENET_B, shuffle=True, seed=6)
        it.reset()
        lenet_batches = [(b.features, b.labels) for _, b in zip(range(SOLVER_LENET_BATCHES), it)]
        for algo in SOLVER_ALGOS:
            conf = LeNet().conf()
            conf.global_conf.optimization_algo = algo
            conf.layers[0].frozen = True
            self.solver_run(f"lenet {algo}", MultiLayerNetwork(conf, device=self.device).init(),
                            "layer_0", lenet_batches, None, workdir)
        rnn_batches = char_batches(SOLVER_RNN_BATCHES, seed=41)
        conf = char_rnn_conf("graves", TRAIN_T)
        conf.tbptt_fwd_length = conf.tbptt_back_length = None
        conf.global_conf.optimization_algo = "LINE_GRADIENT_DESCENT"
        conf.global_conf.solver_iterations = SOLVER_RNN_ITERS
        conf.layers[-1].frozen = True
        self.solver_run("graves char-RNN LINE_GRADIENT_DESCENT",
                        MultiLayerNetwork(conf, device=self.device).init(),
                        f"layer_{LAYERS}", rnn_batches, fused_lstm_graves, workdir,
                        cpu_iters=SOLVER_RNN_CPU_ITERS)
        mconf = char_rnn_conf("lstm", TRAIN_T)
        g = GraphBuilder(dataclasses.replace(
            mconf.global_conf, optimization_algo="CONJUGATE_GRADIENT",
            solver_iterations=SOLVER_RNN_ITERS)).add_inputs("in")
        prev = "in"
        for i, layer in enumerate(mconf.layers):
            g.add_layer(f"layer_{i}", Layer.from_dict(layer.to_dict()), prev)
            prev = f"layer_{i}"
        gconf = g.set_outputs(prev).set_input_types(InputType.recurrent(VOCAB)).build()
        next(n for n in gconf.nodes if n.name == prev).obj.frozen = True
        self.solver_run("graph LSTM char-RNN CONJUGATE_GRADIENT",
                        ComputationGraph(gconf, device=self.device).init(), prev,
                        rnn_batches, fused_lstm, workdir, cpu_iters=SOLVER_RNN_CPU_ITERS)

    def solver_run(self, what, net, frozen, batches, kernels, workdir, cpu_iters=None):
        """One solver run on the card, counted, against the port's CPU run of
        the first batch from the same archive: all of its iterations, or its
        first ``cpu_iters`` (the card's values up to there and its value after
        them against the CPU's values and final loss)."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.models import ModelSerializer
        from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
        path = os.path.join(workdir, "solver.zip")
        net.save(path)
        frozen0 = [t.clone() for t in tree_leaves(net.params()[frozen])]
        counters = all_counters()
        batch_ms = []
        # ---- the main path: counts from 0 just before, read just after
        torch.cuda.synchronize()
        for c in counters:
            c.reset()
        for x, y in batches:
            t0 = time.perf_counter()
            net.fit(x, y)
            torch.cuda.synchronize()
            batch_ms.append(1e3 * (time.perf_counter() - t0))
        counts = {c.name: c.value for c in counters}
        # ----
        log_ = net._solver_log
        evals = sum(r["evaluations"] for r in log_)
        want = {c.name: 0 for c in counters}
        if kernels is not None:
            want[kernels.save_counter.name] = LAYERS * evals
            want[kernels.bwd_counter.name] = LAYERS * evals
            want[kernels.counter.name] = LAYERS * len(batches)
        self.add_launches(counts)
        self.check(counts == want,
                   f"solvers {what}: launches {dict((k, v) for k, v in counts.items() if v)} "
                   f"for {evals} value-and-gradient evaluations over {len(batches)} batches "
                   f"(expected {dict((k, v) for k, v in want.items() if v) or 'none'})")
        still = all(torch.equal(a, b) for a, b in zip(frozen0, tree_leaves(net.params()[frozen])))
        first, last = log_[0]["values"][0], log_[-1]["loss"]
        self.check(still and last < first and all(np.isfinite(r["loss"]) for r in log_),
                   f"solvers {what}: loss {first:.6f} -> {last:.6f} over {len(batches)} batches "
                   f"of {len(log_[0]['values'])} iterations; frozen {frozen} unmoved: {still}")
        log(f"solvers {what}: batch ms " + " ".join(f"{v:.1f}" for v in batch_ms)
            + "; evaluations a batch " + " ".join(str(r["evaluations"]) for r in log_)
            + "; ms an evaluation " + " ".join(f"{m / r['evaluations']:.2f}"
                                              for m, r in zip(batch_ms, log_))
            + f"; {self.card}")
        cpu = ModelSerializer.restore_model(path, device="cpu")
        iters = len(log_[0]["values"])
        k = iters if cpu_iters is None else min(cpu_iters, iters)
        cpu.conf.global_conf.solver_iterations = k
        t0 = time.perf_counter()
        # oneDNN's fp32 convolutions are the inexact side: on LeNet's first
        # batch under LINE_GRADIENT_DESCENT they land 1.7e-4 from the
        # float64 trajectory, PyTorch's own CPU convolutions 3e-7 and the
        # card's cuDNN 2.4e-7 (PERF.md §6)
        with torch.backends.mkldnn.flags(enabled=False):
            cpu.fit(*batches[0])
        cpu_s = time.perf_counter() - t0
        card, host = log_[0], cpu._solver_log[0]
        # the card's values through iteration k: its values before each of
        # the first k and the value after the k-th (the final loss if k is
        # all of them)
        mine = (card["values"] + [card["loss"]])[:k + 1]
        theirs = host["values"] + [host["loss"]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(mine, theirs))
        self.check(len(mine) == len(theirs) and rel <= SOLVER_CPU_TOL,
                   f"solvers {what}: first batch's loss after {k} of {iters} iterations card "
                   f"{mine[-1]!r} vs CPU {theirs[-1]!r} ({cpu_s:.1f} s on the CPU), the "
                   f"{k + 1} values within relative {rel:.3g} tol {SOLVER_CPU_TOL:g}")
        steps = card["steps"][:k]
        log(f"solvers {what}: accepted steps of the first {k} iterations, card "
            + " ".join(f"{s:.6g}" for s in steps)
            + "; CPU " + " ".join(f"{s:.6g}" for s in host["steps"])
            + ("" if np.allclose(steps, host["steps"], rtol=1e-3)
               else " (they differ: a finding)") + f"; evaluations card {card['evaluations']} "
            f"over {iters} iterations, CPU {host['evaluations']} over {k}")
        del cpu

    # ------------------------------------------------------------- runtime
    def runtime_phase(self, workdir):
        """The training runtime under every fit loop: grouped and captured
        dispatch of config #4, LeNet with and without captured graphs,
        ResNet-50 through the prefetcher and the TrainingProfiler, fresh
        dropout masks in replayed zoo-BERT groups, a fault-tolerant restart,
        early stopping and gradient checks on the card; then the captured
        graphs' counters."""
        from deeplearning4j_tpu_torch.runtime import compile_cache
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        env = get_environment()
        compile_cache.reset_stats()
        try:
            for name, part in (("config #4", self.runtime_sd_bert),
                               ("lenet", lambda: self.runtime_lenet(workdir)),
                               ("resnet", self.runtime_resnet),
                               ("zoo bert", self.runtime_zoo_bert),
                               ("fault tolerance", lambda: self.runtime_fault_tolerance(workdir)),
                               ("early stopping", self.runtime_early_stopping),
                               ("gradient check", self.runtime_gradient_check)):
                self.phase(f"runtime {name}", part)
        finally:
            env.set_dispatch_unroll(1).set_aot_dispatch(True).set_packed_state(True)
            self.torch.backends.cudnn.deterministic = False
            env.allow_bfloat16()
        s = compile_cache.stats()
        log(f"runtime: captured graphs {s['aot_compiles']} ({s['aot_compile_seconds']:.2f} s of "
            f"capture), replays {s['aot_replays']}, signature drifts {s['aot_fallbacks']}; kernel "
            f"build cache: {s['hits']} loaded, {s['misses']} built, {s['corrupt_entries']} corrupt")
        self.check(s["aot_compiles"] > 0 and s["aot_replays"] > 0,
                   f"runtime: captured graphs replayed ({s['aot_compiles']} captured, "
                   f"{s['aot_replays']} replays)")

    def runtime_sd_bert(self):
        """Config #4 as ``bench_imported_bert`` runs it: one epoch of 48
        repeated batches at B=64, T=128, bf16, Adam(2e-5), three ways:
        ``dispatch_unroll(4)`` (a 4-step captured graph), one-step captured
        graphs, and ``aot_dispatch`` off (the eager step). Each: step ms,
        samples/s, device busy and its share, peak memory, the flash
        launches, and its losses and final weights against the eager run."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.autodiff.samediff import TrainingConfig
        from deeplearning4j_tpu_torch.data import ExistingDataSetIterator
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        from deeplearning4j_tpu_torch.runtime import compile_cache
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.train.updaters import Adam
        env = get_environment()
        env.allow_bfloat16()
        sd, inputs, init, mds = self.sd_bert("runtime config #4")
        names = sorted(init)
        counters = all_counters()
        flash = (fa.lse_counter, fa.bwd_dq_counter, fa.bwd_dkv_counter)
        runs = {}
        for mode, aot, unroll in (("eager", False, 1), ("unroll 4", True, RUNTIME_UNROLL),
                                  ("aot 1", True, 1)):
            with torch.no_grad():
                for n, t in init.items():
                    sd.arrays[n].copy_(t)
            sd.set_training_config(TrainingConfig(
                updater=Adam(2e-5), data_set_feature_mapping=list(inputs),
                data_set_label_mapping=["labels"]))
            sd._train_iter = 0
            sd.set_listeners()
            env.set_aot_dispatch(aot).set_dispatch_unroll(unroll)
            compile_cache.reset_stats()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for c in counters:
                c.reset()
            t0 = time.perf_counter()
            # ---- the main path: counts from 0 just before, read just after
            losses = list(sd.fit(ExistingDataSetIterator([mds] * RUNTIME_SD_STEPS)))
            torch.cuda.synchronize()
            first_wall = time.perf_counter() - t0
            counts = {c.name: c.value for c in counters}
            # ----
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            stats = compile_cache.stats()
            weights = [sd.arrays[n].detach().float().clone() for n in names]
            # the steady state: the same fit again, every graph captured
            t0 = time.perf_counter()
            sd.fit(ExistingDataSetIterator([mds] * RUNTIME_SD_STEPS))
            torch.cuda.synchronize()
            step_ms = 1e3 * (time.perf_counter() - t0) / RUNTIME_SD_STEPS
            runs[mode] = (losses, weights)
            want = {c.name: (BERT_LAYERS * RUNTIME_SD_STEPS if c in flash else 0)
                    for c in counters}
            self.add_launches({c.name: counts[c.name] for c in flash})
            self.check(counts == want and len(losses) == RUNTIME_SD_STEPS
                       and all(np.isfinite(v) for v in losses),
                       f"runtime config #4 {mode}: {RUNTIME_SD_STEPS} finite losses, launch "
                       f"counts {counts} (expected {want})")
            log(f"runtime config #4 {mode}: first fit {first_wall:.3f} s ({stats['aot_compiles']} "
                f"graphs captured in {stats['aot_compile_seconds']:.3f} s, {stats['aot_replays']} "
                f"replays); steady fit {step_ms:.2f} ms a step (mean of {RUNTIME_SD_STEPS}), "
                f"{BERT_B / step_ms * 1e3:.0f} samples/s; peak device memory {peak:.2f} GiB; "
                f"losses first {losses[0]:.5f} last {losses[-1]:.5f}")
            k = unroll
            self.device_breakdown(
                lambda k=k: sd.fit(ExistingDataSetIterator([mds] * k)),
                f"runtime config #4 {mode}: one dispatch of {k} step(s)", reps=3,
                step_ms=step_ms * k)
            if mode != "eager":
                ref_l, ref_w = runs["eager"]
                dl = max(abs(a - b) for a, b in zip(losses, ref_l))
                top = max(float(w.abs().max()) for w in ref_w)
                dw = max(float((a - b).abs().max()) for a, b in zip(weights, ref_w))
                self.check(dl <= RUNTIME_REL_TOL * max(abs(v) for v in ref_l)
                           and dw <= RUNTIME_REL_TOL * top,
                           f"runtime config #4 {mode} against the eager step: losses max abs "
                           f"diff {dl:.3g}, final weights max abs diff {dw:.3g} (largest |w| "
                           f"{top:.3g}; limit {RUNTIME_REL_TOL:g} relative)")
        del sd, init
        torch.cuda.empty_cache()

    def runtime_lenet(self, workdir):
        """LeNet one epoch, fp32, TF32 off, packed with one-step captured
        graphs and with ``aot_dispatch`` off: step ms, the busy share,
        test accuracy, and the first losses against the CPU."""
        torch = self.torch
        from deeplearning4j_tpu_torch.data import (ListDataSetIterator, MnistDataSetIterator,
                                                   NumpyDataSetIterator)
        from deeplearning4j_tpu_torch.models import MultiLayerNetwork
        from deeplearning4j_tpu_torch.runtime import compile_cache
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
        from deeplearning4j_tpu_torch.zoo import LeNet
        env = get_environment()
        env.set_compute_dtype(torch.float32)
        train = MnistDataSetIterator(LENET_B, train=True)
        test = MnistDataSetIterator(LENET_B, train=False)
        init_path = os.path.join(workdir, "runtime-lenet-init.zip")
        LeNet().init(device=self.device).save(init_path)
        first = NumpyDataSetIterator(train.features, train.labels, LENET_B, shuffle=True, seed=6)
        first.reset()
        first = [b for _, b in zip(range(LENET_CMP_STEPS), first)]
        for mode, aot in (("captured", True), ("eager", False)):
            env.set_aot_dispatch(aot)
            net = MultiLayerNetwork.load(init_path, device=self.device)
            scores, stamps = CollectScoresListener(), []
            net.set_listeners(scores, DoneStamps(stamps))
            compile_cache.reset_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net.fit(train)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            stats = compile_cache.stats()
            losses = [v for _, v in scores.scores]
            step_ms = sorted(1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
            med = step_ms[len(step_ms) // 2]
            acc = net.evaluate(test).accuracy()
            log(f"runtime lenet {mode}: {len(losses)} steps in {wall:.3f} s; step ms median "
                f"{med:.3f} (p90 {step_ms[int(0.9 * len(step_ms))]:.3f}); "
                f"{LENET_B / med * 1e3:.0f} img/s at the median; {stats['aot_compiles']} graphs, "
                f"{stats['aot_replays']} replays; test accuracy {acc:.4f}")
            net.set_listeners()
            x, y = train.features[:LENET_B], train.labels[:LENET_B]
            self.device_breakdown(lambda: net.fit(x, y), f"runtime lenet {mode} step", reps=10,
                                  step_ms=med)
            self.check(len(losses) == LENET_STEPS and acc >= LENET_MIN_ACC
                       and (stats["aot_replays"] >= LENET_STEPS - 2 if aot else
                            stats["aot_replays"] == 0),
                       f"runtime lenet {mode}: {len(losses)} steps, test accuracy {acc:.4f} "
                       f"(>= {LENET_MIN_ACC}), {stats['aot_replays']} replays")
            if aot:
                cpu = MultiLayerNetwork.load(init_path, device="cpu")
                cpu_scores = CollectScoresListener()
                cpu.set_listeners(cpu_scores)
                cpu.fit(ListDataSetIterator(first))
                want = [v for _, v in cpu_scores.scores]
                err = max(abs(a - b) for a, b in zip(losses[:LENET_CMP_STEPS], want))
                self.check(err <= LENET_TOL,
                           f"runtime lenet captured: first {LENET_CMP_STEPS} losses "
                           f"{' '.join(f'{v:.6f}' for v in losses[:LENET_CMP_STEPS])} vs CPU "
                           f"{' '.join(f'{v:.6f}' for v in want)}: max_abs_err={err:.3g} "
                           f"tol={LENET_TOL:g}")
            del net
        env.set_aot_dispatch(True)

    def runtime_resnet(self):
        """ResNet-50 at bench_resnet's step (batch 256, 224x224, bf16,
        Nesterovs(0.1, 0.9)), RESNET_STEPS steps of one host batch through
        ``prefetch_buffer=2`` and a TrainingProfiler, against the same steps
        with ``prefetch_buffer=0`` from the same weights: the same losses,
        bit for bit, and 36 conv_stats launches a step."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
        from deeplearning4j_tpu_torch.ops.kernels import conv_stats as cs
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
        from deeplearning4j_tpu_torch.train.profiler import TrainingProfiler
        from deeplearning4j_tpu_torch.train.updaters import Nesterovs
        from deeplearning4j_tpu_torch.zoo import ResNet50
        get_environment().allow_bfloat16()
        torch.cuda.empty_cache()
        rng = np.random.default_rng(0)
        x = rng.standard_normal((RESNET_B, RESNET_HW, RESNET_HW, 3), dtype=np.float32)
        y = np.eye(RESNET_CLASSES, dtype=np.float32)[rng.integers(0, RESNET_CLASSES, RESNET_B)]
        zoo = ResNet50(num_classes=RESNET_CLASSES, height=RESNET_HW, width=RESNET_HW,
                       updater=Nesterovs(0.1, momentum=0.9))
        base = zoo.init(device=self.device)
        runs = {}
        for prefetch in (0, 2):
            net = base.clone()  # the same weights and statistics, a fresh optimizer
            scores, prof = CollectScoresListener(), TrainingProfiler()
            net.set_listeners(scores)
            cs.counter.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net.fit(ListDataSetIterator([DataSet(x, y)] * RESNET_STEPS),
                    prefetch_buffer=prefetch, profiler=prof)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = cs.counter.value
            losses = [v for _, v in scores.scores]
            runs[prefetch] = losses
            r = prof.report()
            # the steady state: 5 more steps, every one a replay, timed alone
            t1 = time.perf_counter()
            net.fit(ListDataSetIterator([DataSet(x, y)] * 5), prefetch_buffer=prefetch)
            torch.cuda.synchronize()
            log(f"runtime resnet prefetch_buffer={prefetch}: 5 replayed steps "
                f"{1e3 * (time.perf_counter() - t1) / 5:.2f} ms a step")
            log(f"runtime resnet prefetch_buffer={prefetch}: {RESNET_STEPS} steps in {wall:.3f} s; "
                f"{prof.summary()}; data wait total {r['data_wait_total_s']:.3f} s "
                f"(mean {r['data_wait_mean_ms']:.3f} ms), dispatch mean {r['dispatch_mean_ms']:.3f}"
                f" ms (p99 {r['dispatch_p99_ms']:.3f}), step mean {r['step_mean_ms']:.3f} ms "
                f"(p99 {r['step_p99_ms']:.3f}); conv_stats launches {launches}")
            self.check(launches == RESNET_PAIRS * RESNET_STEPS and r["iterations"] == RESNET_STEPS
                       and all(np.isfinite(v) for v in losses),
                       f"runtime resnet prefetch_buffer={prefetch}: {launches} conv_stats "
                       f"launches (expected {RESNET_PAIRS * RESNET_STEPS}), {r['iterations']} "
                       f"profiled iterations, finite losses")
            del net
            torch.cuda.empty_cache()
        del base
        self.check(runs[2] == runs[0],
                   "runtime resnet: the losses of prefetch_buffer=2 equal prefetch_buffer=0's: "
                   + " ".join(f"{a:.5f}/{b:.5f}" for a, b in zip(runs[2], runs[0])))

    def runtime_zoo_bert(self):
        """``Bert.base()`` (dropout 0.1) fine-tuned with
        ``dispatch_unroll(4)`` in RUNTIME_BERT_FITS fits of one group each on
        every_token's labels: the dropout masks of each replayed group (read
        from the graph's own buffers after the fit) differ from step to
        step and from replay to replay, with the drop share in
        RUNTIME_DROP_BAND; the first losses against the plain-attention
        trainer; the loss falls as in ``train bert``."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
        from deeplearning4j_tpu_torch.models import MultiLayerNetwork
        from deeplearning4j_tpu_torch.nn import attention_layers
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
        from deeplearning4j_tpu_torch.zoo import Bert
        env = get_environment()
        env.allow_bfloat16()
        init = Bert.base().init(device=self.device).params()
        batches = label_batches(RUNTIME_UNROLL * RUNTIME_BERT_FITS, 99, every_token)
        fmask = np.ones((BERT_B, BERT_T), np.float32)
        net = MultiLayerNetwork(Bert.base().conf(), device=self.device).init(
            params=clone_tree(init))
        scores = CollectScoresListener()
        net.set_listeners(scores)
        masks = []
        draw = attention_layers.keep_mask

        def recording(x, keep, generator):
            m = draw(x, keep, generator)
            masks.append(m)
            return m

        env.set_dispatch_unroll(RUNTIME_UNROLL)
        attention_layers.keep_mask = recording
        per_fit = []
        try:
            for f in range(RUNTIME_BERT_FITS):
                masks.clear()
                group = batches[f * RUNTIME_UNROLL:(f + 1) * RUNTIME_UNROLL]
                net.fit(ListDataSetIterator([DataSet(x, y, features_mask=fmask)
                                             for x, y in group]))
                torch.cuda.synchronize()
                # the masks the Python step made in this fit: on a replay
                # none (the graph's own buffers are read instead), so keep
                # the last capture's and read what the replay wrote there
                if masks:
                    captured = list(masks)
                per_fit.append([m.clone() for m in captured])
            # the steady state: one more group, a replay, timed alone
            t0 = time.perf_counter()
            net.fit(ListDataSetIterator([DataSet(x, y, features_mask=fmask) for x, y in group]))
            torch.cuda.synchronize()
            step_ms = 1e3 * (time.perf_counter() - t0) / RUNTIME_UNROLL
        finally:
            attention_layers.keep_mask = draw
            env.set_dispatch_unroll(1)
        log(f"runtime zoo bert dispatch_unroll({RUNTIME_UNROLL}): a replayed group {step_ms:.2f} "
            f"ms a step, {BERT_B / step_ms * 1e3:.0f} samples/s")
        losses = [v for _, v in scores.scores][:RUNTIME_UNROLL * RUNTIME_BERT_FITS]
        sites = len(per_fit[-1]) // RUNTIME_UNROLL
        drops = [1.0 - float(m.float().mean()) for ms in per_fit for m in ms]
        in_band = all(RUNTIME_DROP_BAND[0] < d < RUNTIME_DROP_BAND[1] for d in drops)
        replays = per_fit[2:]  # fits 3.. replay the 4-step graph captured in fit 2
        step_apart = all(not torch.equal(ms[i * sites], ms[(i + 1) * sites])
                         for ms in replays for i in range(RUNTIME_UNROLL - 1))
        replay_apart = all(not torch.equal(a[0], b[0]) for a, b in zip(replays, replays[1:]))
        self.check(in_band and step_apart and replay_apart and sites > 0,
                   f"runtime zoo bert dispatch_unroll({RUNTIME_UNROLL}): {sites} dropout sites "
                   f"a step; drop shares {min(drops):.4f}..{max(drops):.4f} (band "
                   f"{RUNTIME_DROP_BAND}); masks differ between the steps of a replayed group: "
                   f"{step_apart}; between replays: {replay_apart}")
        with plain_attention():
            want, _, _ = self.bert_fit(init, batches[:BERT_CMP_STEPS], torch.bfloat16)
        err = max(abs(a - b) for a, b in zip(losses[:BERT_CMP_STEPS], want))
        self.check(err <= BERT_TRAIN_TOL["bfloat16"],
                   f"runtime zoo bert: first {BERT_CMP_STEPS} losses "
                   f"{' '.join(f'{v:.5f}' for v in losses[:BERT_CMP_STEPS])} vs the plain "
                   f"attention {' '.join(f'{v:.5f}' for v in want)}: max_abs_err={err:.3g} "
                   f"tol={BERT_TRAIN_TOL['bfloat16']:g}")
        tail = sum(losses[-3:]) / 3
        limit = BERT_LOSS_FALL * min(losses[0], math.log(2))
        self.check(len(losses) == RUNTIME_UNROLL * RUNTIME_BERT_FITS and tail < limit,
                   f"runtime zoo bert: loss {losses[0]:.4f} -> mean of the last 3 {tail:.4f} "
                   f"(must fall below {limit:.4f}): " + " ".join(f"{v:.4f}" for v in losses))
        del net, init
        torch.cuda.empty_cache()

    def runtime_fault_tolerance(self, workdir):
        """A FaultTolerantTrainer on LeNet (fp32) with a chaos fault at the
        RUNTIME_FT_FAULT-th batch fetch: it restarts from the last
        checkpoint and finishes with the weights of an uninterrupted run
        (cuDNN deterministic for both, whose default backward-filter
        algorithms sum in no fixed order)."""
        torch = self.torch
        from deeplearning4j_tpu_torch.data import MnistDataSetIterator
        from deeplearning4j_tpu_torch.runtime.chaos import ChaosController, FailNth
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
        from deeplearning4j_tpu_torch.train import FaultTolerantTrainer
        from deeplearning4j_tpu_torch.train.checkpoint import (CheckpointListener,
                                                               load_manifest, verify_checkpoint)
        from deeplearning4j_tpu_torch.zoo import LeNet
        get_environment().set_compute_dtype(torch.float32)
        torch.backends.cudnn.deterministic = True
        it = MnistDataSetIterator(LENET_B, train=True, num_examples=LENET_B * RUNTIME_FT_BATCHES,
                                  shuffle=False)
        dirs = [os.path.join(workdir, f"ft-{k}") for k in ("fault", "clean")]
        faulty = FaultTolerantTrainer(lambda: LeNet().init(device=self.device), dirs[0],
                                      every_n_iterations=RUNTIME_FT_EVERY)
        t0 = time.perf_counter()
        with ChaosController(seed=1) as c:
            c.on("train.prefetch.fetch", FailNth(RUNTIME_FT_FAULT))
            a = faulty.fit(it, epochs=1)
        wall = time.perf_counter() - t0
        b = FaultTolerantTrainer(lambda: LeNet().init(device=self.device), dirs[1],
                                 every_n_iterations=RUNTIME_FT_EVERY).fit(it, epochs=1)
        torch.backends.cudnn.deterministic = False
        top = max(float(w.abs().max()) for w in tree_leaves(b.params()))
        diff = max(float((u - v).abs().max())
                   for u, v in zip(tree_leaves(a.params()), tree_leaves(b.params())))
        ck = CheckpointListener.last_checkpoint_in(dirs[0])
        ok = ck is not None and verify_checkpoint(ck, load_manifest(dirs[0]).get(
            os.path.basename(ck)))
        self.check(faulty.restarts == 1 and a.iteration == b.iteration == RUNTIME_FT_BATCHES
                   and diff <= RUNTIME_REL_TOL * top and ok,
                   f"runtime fault tolerance: a fault at fetch {RUNTIME_FT_FAULT}, "
                   f"{faulty.restarts} restart(s) from the checkpoint at iteration "
                   f"{RUNTIME_FT_EVERY * ((RUNTIME_FT_FAULT - 1) // RUNTIME_FT_EVERY)}, "
                   f"{a.iteration} iterations in {wall:.2f} s; final weights against the "
                   f"uninterrupted run: max abs diff {diff:.3g} (largest |w| {top:.3g}); "
                   f"verify_checkpoint({os.path.basename(ck or '-')}) {ok}")

    def runtime_early_stopping(self):
        """EarlyStoppingTrainer on LeNet: at most RUNTIME_ES_EPOCHS epochs,
        ScoreImprovementEpochTerminationCondition(1), scored by the test
        set's loss; the best epoch and score."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.data import MnistDataSetIterator
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.train import (DataSetLossCalculator,
                                                    EarlyStoppingConfiguration,
                                                    EarlyStoppingTrainer,
                                                    MaxEpochsTerminationCondition,
                                                    ScoreImprovementEpochTerminationCondition)
        from deeplearning4j_tpu_torch.zoo import LeNet
        get_environment().set_compute_dtype(torch.float32)
        test = MnistDataSetIterator(LENET_B, train=False)
        cfg = (EarlyStoppingConfiguration.builder()
               .score_calculator(DataSetLossCalculator(test))
               .epoch_termination_conditions(ScoreImprovementEpochTerminationCondition(1),
                                             MaxEpochsTerminationCondition(RUNTIME_ES_EPOCHS))
               .build())
        t0 = time.perf_counter()
        result = EarlyStoppingTrainer(cfg, LeNet().init(device=self.device),
                                      MnistDataSetIterator(LENET_B, train=True)).fit()
        wall = time.perf_counter() - t0
        acc = result.best_model.evaluate(test).accuracy()
        scores = [result.score_vs_epoch[k] for k in sorted(result.score_vs_epoch)]
        self.check(result.total_epochs <= RUNTIME_ES_EPOCHS and all(np.isfinite(scores))
                   and 0 <= result.best_model_epoch < result.total_epochs
                   and acc >= LENET_MIN_ACC,
                   f"runtime early stopping: {result.termination_reason} "
                   f"({result.termination_details}) after {result.total_epochs} epochs in "
                   f"{wall:.1f} s; scores " + " ".join(f"{v:.4g}" for v in scores)
                   + f"; best epoch {result.best_model_epoch}, score "
                   f"{result.best_model_score:.4g}, its test accuracy {acc:.4f}")

    def runtime_gradient_check(self):
        """GradientCheckUtil in float64 on the card: a convolution +
        BatchNormalization + dense net passes; an LSTM net raises by the
        kernels' dtype rule (they take float32 or bfloat16)."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.models import MultiLayerNetwork
        from deeplearning4j_tpu_torch.nn import (LSTM, BatchNormalization, ConvolutionLayer,
                                                 DenseLayer, InputType, NeuralNetConfiguration,
                                                 OutputLayer, RnnOutputLayer)
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.train.gradient_check import GradientCheckUtil
        get_environment().set_compute_dtype(torch.float32)
        rng = np.random.default_rng(0)
        conf = (NeuralNetConfiguration.builder().seed(3).list()
                .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3), activation="tanh"))
                .layer(BatchNormalization())
                .layer(DenseLayer(n_out=8, activation="tanh"))
                .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
                .set_input_type(InputType.convolutional(6, 6, 2)).build())
        net = MultiLayerNetwork(conf, device=self.device).init()
        ok = GradientCheckUtil.check_gradients(net, rng.normal(size=(4, 6, 6, 2)),
                                               np.eye(3)[rng.integers(0, 3, 4)])
        conf = (NeuralNetConfiguration.builder().seed(3).list().layer(LSTM(n_out=8))
                .layer(RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent"))
                .set_input_type(InputType.recurrent(5)).build())
        lstm = MultiLayerNetwork(conf, device=self.device).init()
        try:
            GradientCheckUtil.check_gradients(lstm, rng.normal(size=(2, 4, 5)),
                                              np.eye(3)[rng.integers(0, 3, (2, 4))])
            raised = "nothing"
        except TypeError as e:
            raised = str(e)
        self.check(ok and "float32 or bfloat16" in raised,
                   f"runtime gradient check on the card, float64: conv + BatchNormalization + "
                   f"dense passes: {ok}; an LSTM net raises: {raised}")

    def lenet_phase(self, workdir):
        """BASELINE config #1 on the card: the zoo LeNet trained by ``fit``
        for one epoch of synthetic MNIST (the main path, counted: it runs no
        kernel of the port, only cuDNN and cuBLAS); step ms, img/s, peak
        memory, a device-busy breakdown of one step and PerformanceListener's
        reading; ``evaluate`` on the test set; the first losses against the
        same net on the CPU; 3 steps under each updater option, card against
        CPU; the trained net with its normalizer through an archive and
        ``ModelRegistry``."""
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        env = get_environment()
        saved_dtype = env.compute_dtype
        env.set_compute_dtype("float32")
        try:
            self._lenet(workdir)
        finally:
            env.set_compute_dtype(saved_dtype)

    def _lenet(self, workdir):
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.data import (ImagePreProcessingScaler, ListDataSetIterator,
                                                   MnistDataSetIterator, NumpyDataSetIterator)
        from deeplearning4j_tpu_torch.models import ModelSerializer, MultiLayerNetwork
        from deeplearning4j_tpu_torch.serving import ModelRegistry
        from deeplearning4j_tpu_torch.train.listeners import (CollectScoresListener,
                                                              PerformanceListener)
        from deeplearning4j_tpu_torch.zoo import LeNet
        t0 = time.perf_counter()
        train = MnistDataSetIterator(LENET_B, train=True)
        test = MnistDataSetIterator(LENET_B, train=False)
        net = LeNet().init(device=self.device)
        init_path = os.path.join(workdir, "lenet-init.zip")
        net.save(init_path)
        log(f"lenet: synthetic={train.synthetic} MNIST, {len(train.features)} training and "
            f"{len(test.features)} test images, {time.perf_counter() - t0:.1f} s with the init; "
            f"{net.num_params()} parameters\n{net.summary()}")
        self.check(train.synthetic and len(train.features) == 60000,
                   "lenet trains on the 60000 synthetic MNIST images")
        # the batches fit sees first: the same arrays and shuffle seed, reset
        # as fit resets
        first = NumpyDataSetIterator(train.features, train.labels, LENET_B, shuffle=True,
                                     seed=6)
        first.reset()
        first = [b for _, b in zip(range(LENET_CMP_STEPS), first)]
        scores, stamps = CollectScoresListener(), []
        perf = PerformanceListener(frequency=LENET_PERF_FREQ)
        net.set_listeners(scores, StepStamps(stamps), perf)
        counters = all_counters()

        # ---- the main path: counts from 0 just before, read just after
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        net.fit(train)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {c.name: c.value for c in counters}
        # ----
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        self.check(all(v == 0 for v in counts.values()),
                   f"lenet fit launches no kernel of the port (cuDNN and cuBLAS only): {counts}")
        losses = [v for _, v in scores.scores]
        self.check(len(losses) == LENET_STEPS and all(np.isfinite(v) for v in losses)
                   and losses[-1] < losses[0],
                   f"lenet fit: {len(losses)} steps (expected {LENET_STEPS}), loss first "
                   f"{losses[0]:.5f}, at 100 {losses[min(99, len(losses) - 1)]:.5f}, last "
                   f"{losses[-1]:.3g}")
        step_ms = sorted(1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
        med = step_ms[len(step_ms) // 2]
        log(f"lenet train: {len(losses)} steps of batch {LENET_B} (one epoch) fp32 in {wall:.3f} s "
            f"({len(train.features) / wall:.0f} img/s over the epoch); step ms after the first: "
            f"median {med:.3f} (min {step_ms[0]:.3f}, p90 {step_ms[int(0.9 * len(step_ms))]:.3f}, "
            f"max {step_ms[-1]:.3f}); {LENET_B / med * 1e3:.0f} img/s at the median; first step "
            f"{1e3 * (stamps[0] - t0):.1f} ms; peak memory {peak:.1f} MiB")
        log("lenet PerformanceListener (host clock, the loss read at each report): " + "; ".join(
            f"it {it} {its:.1f} it/s {sps:.0f} samples/s" for it, its, sps, _ in perf.reports))
        net.set_listeners()
        x, y = train.features[:LENET_B], train.labels[:LENET_B]
        self.device_breakdown(lambda: net.fit(x, y), f"lenet fit step (batch {LENET_B})",
                              reps=10, step_ms=med)

        # ---- evaluation on the test set
        t0 = time.perf_counter()
        ev = net.evaluate(test)
        log(f"lenet evaluate: {ev.total} test images in {time.perf_counter() - t0:.2f} s\n"
            + ev.stats())
        self.check(ev.total == len(test.features) and ev.accuracy() >= LENET_MIN_ACC,
                   f"lenet test accuracy {ev.accuracy():.4f} (must be >= {LENET_MIN_ACC})")

        # ---- the card against the CPU: the first losses of the main path
        cpu = MultiLayerNetwork.load(init_path, device="cpu")
        cpu_scores = CollectScoresListener()
        cpu.set_listeners(cpu_scores)
        cpu.fit(ListDataSetIterator(first))
        want = [v for _, v in cpu_scores.scores]
        err = max(abs(a - b) for a, b in zip(losses[:LENET_CMP_STEPS], want))
        self.check(err <= LENET_TOL,
                   f"lenet fp32 losses of the first {LENET_CMP_STEPS} steps, card "
                   f"{' '.join(f'{v:.6f}' for v in losses[:LENET_CMP_STEPS])} vs CPU from the "
                   f"same archive {' '.join(f'{v:.6f}' for v in want)}: max_abs_err={err:.3g} "
                   f"tol={LENET_TOL:g}")
        self.lenet_options(first, workdir)

        # ---- serving: the trained net and its normalizer through an archive
        scaler = ImagePreProcessingScaler(0.0, 1.0, max_pixel=255.0)
        path = os.path.join(workdir, "lenet.zip")
        ModelSerializer.write_model(net, path, normalizer=scaler)
        back = ModelSerializer.restore_normalizer(path)
        self.check(type(back) is ImagePreProcessingScaler and
                   (float(back.min_range), float(back.max_range), float(back.max_pixel)) ==
                   (0.0, 1.0, 255.0),
                   f"lenet restore_normalizer gives back the scaler: {type(back).__name__} "
                   f"{getattr(back, 'min_range', None)}..{getattr(back, 'max_range', None)} "
                   f"of {getattr(back, 'max_pixel', None)}")
        reg = ModelRegistry()
        served = reg.load("lenet", path, device=self.device, max_batch_size=LENET_B)
        rng = np.random.default_rng(15)
        rows = rng.integers(1, LENET_B + 1, (CLIENTS, REQUESTS_PER_CLIENT))
        rows[0, 0], rows[1, 0] = 1, LENET_B
        images = test.features
        reqs = [[images[rng.integers(0, len(images), int(n))] for n in r] for r in rows]
        answers = [[None] * REQUESTS_PER_CLIENT for _ in range(CLIENTS)]
        errors = []

        def client(c):
            try:
                for k, r in enumerate(reqs[c]):
                    answers[c][k] = reg.predict("lenet", r)
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,), name=f"smoke-lenet-{c}")
                   for c in range(CLIENTS)]
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        counts = {c.name: c.value for c in counters}
        self.check(not errors and all(v == 0 for v in counts.values()),
                   f"lenet serving: {CLIENTS * REQUESTS_PER_CLIENT} requests in {wall:.3f} s over "
                   f"{served.batcher.batches} batches (buckets {served.batcher.bucket_counts}), "
                   f"errors={errors}, port kernel launches {counts}")
        worst = 0.0
        for c in range(CLIENTS):
            for k, r in enumerate(reqs[c]):
                got = answers[c][k]
                own = net.output(r).cpu().numpy()
                ok = got is not None and got.shape == (len(r), 10)
                worst = max(worst, float(np.abs(got - own).max()) if ok else float("inf"))
        self.check(worst <= LENET_SERVE_TOL,
                   f"lenet {CLIENTS * REQUESTS_PER_CLIENT} served answers vs net.output on the "
                   f"same rows: max_abs_err={worst:.3g} tol={LENET_SERVE_TOL:g}")
        x = images[:LENET_B]
        reg.predict("lenet", x)  # warm-up
        ms = []
        for _ in range(20):
            t_req = time.perf_counter()
            reg.predict("lenet", x)
            ms.append(1e3 * (time.perf_counter() - t_req))
        ms.sort()
        p50 = ms[len(ms) // 2]
        log(f"lenet serving (fp32): 20 sequential {LENET_B}-row requests: p50 {p50:.3f} ms "
            f"(min {ms[0]:.3f}, max {ms[-1]:.3f}), {LENET_B / p50 * 1e3:.0f} samples/s at p50")
        self.device_breakdown(lambda: net.output(x), f"lenet {LENET_B}-row output")
        reg.shutdown()
        self.check(not served.batcher._worker.is_alive(), "lenet registry shut down")
        del net, served, reg
        torch.cuda.empty_cache()

    def lenet_options(self, batches, workdir):
        """3 steps of the zoo LeNet under each updater option the port
        gained with it, card against CPU from one archive: AdaMax, AMSGrad,
        Nadam, AdaGrad, AdaDelta, Sgd under a StepSchedule, and Adam with
        ClipL2PerLayer gradient normalization, l2 and weight decay."""
        from deeplearning4j_tpu_torch.data import ListDataSetIterator
        from deeplearning4j_tpu_torch.models import MultiLayerNetwork
        from deeplearning4j_tpu_torch.train import updaters as upd
        from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
        from deeplearning4j_tpu_torch.train.schedules import StepSchedule
        from deeplearning4j_tpu_torch.zoo import LeNet
        options = [("AdaMax", upd.AdaMax(1e-3), {}), ("AMSGrad", upd.AMSGrad(1e-3), {}),
                   ("Nadam", upd.Nadam(1e-3), {}), ("AdaGrad", upd.AdaGrad(1e-2), {}),
                   ("AdaDelta", upd.AdaDelta(), {}),
                   ("Sgd(StepSchedule)", upd.Sgd(StepSchedule(initial_value=0.05, decay_rate=0.5,
                                                              step_size=1)), {}),
                   ("Adam+ClipL2PerLayer+l2+weight_decay", upd.Adam(1e-3),
                    {"gradient_normalization": "ClipL2PerLayer",
                     "gradient_normalization_threshold": 1.0, "l2": 1e-4,
                     "weight_decay": 1e-4})]
        for name, updater, extra in options:
            conf = LeNet(updater=updater).conf()
            for k, v in extra.items():
                setattr(conf.global_conf, k, v)
            card = MultiLayerNetwork(conf, device=self.device).init()
            path = os.path.join(workdir, "lenet-option.zip")
            card.save(path)
            cpu = MultiLayerNetwork.load(path, device="cpu")
            got, want = CollectScoresListener(), CollectScoresListener()
            card.set_listeners(got)
            cpu.set_listeners(want)
            card.fit(ListDataSetIterator(batches))
            cpu.fit(ListDataSetIterator(batches))
            g, w = [v for _, v in got.scores], [v for _, v in want.scores]
            err = max(abs(a - b) for a, b in zip(g, w))
            self.check(len(g) == LENET_CMP_STEPS and err <= LENET_TOL,
                       f"lenet {name}: {len(g)} losses, card {' '.join(f'{v:.6f}' for v in g)} "
                       f"vs CPU {' '.join(f'{v:.6f}' for v in w)}: max_abs_err={err:.3g} "
                       f"tol={LENET_TOL:g}")

    # ------------------------------------------------------------ parallel
    def parallel_phase(self, workdir):
        """Config #5 on the card (``ParallelWrapper`` over a mesh that
        repeats cuda:0, the pipe plans, the distributed trainer over gloo,
        ring attention); each part a phase of its own."""
        for name, part in (("wrapper", self.parallel_wrapper),
                           ("pipe", self.parallel_pipe),
                           ("distributed", lambda: self.parallel_distributed(workdir)),
                           ("ring attention", self.parallel_ring)):
            self.phase(f"parallel {name}", part)

    def par_bert_fit(self, init, plan):
        """10 steps of Bert.base() from ``init`` on the synthetic batch, by
        the net's own ``fit`` (``plan`` None) or a ``ParallelWrapper``:
        ``(losses, [start] + step stamps, net, wrapper, flash counts, wall
        s)``."""
        from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
        from deeplearning4j_tpu_torch.imports.tf_oracles import bert_synthetic_batch
        from deeplearning4j_tpu_torch.models import MultiLayerNetwork
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        from deeplearning4j_tpu_torch.parallel import ParallelWrapper
        from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
        from deeplearning4j_tpu_torch.zoo import Bert
        torch = self.torch
        ids, _, mask, labels = bert_synthetic_batch(BERT_B, BERT_T, BERT_VOCAB, seed=1)
        ds = DataSet(ids, labels, features_mask=mask.astype("float32"))
        net = MultiLayerNetwork(Bert.base(dropout_rate=0.0).conf(), device=self.device).init(
            params=clone_tree(init))
        scores, stamps = CollectScoresListener(), []
        net.set_listeners(scores, StepStamps(stamps))
        pw = None if plan is None else ParallelWrapper(net, plan)
        counters = all_counters()
        torch.cuda.synchronize()
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        (net if pw is None else pw).fit(ListDataSetIterator([ds] * PAR_STEPS))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {c.name: c.value for c in counters}
        flash = {c.name for c in (fa.lse_counter, fa.bwd_dq_counter, fa.bwd_dkv_counter)}
        others = {k: v for k, v in counts.items() if k not in flash and v}
        self.check(not others, f"parallel: only the flash kernels launched ({others or 'none'})")
        return [v for _, v in scores.scores], [t0] + stamps, net, pw, \
            {k: counts[k] for k in sorted(flash)}, wall

    def parallel_wrapper(self):
        """ParallelWrapper on BERT-base over PAR_WAYS x cuda:0: data
        parallel, FSDP and tensor parallel, each beside its compose() twin;
        data parallel against the net's own fit; flash launches per replica
        counted; step ms, samples/s, busy share, peak memory."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        from deeplearning4j_tpu_torch.parallel import ParallelPlan
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.runtime.mesh import create_mesh
        from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
        from deeplearning4j_tpu_torch.zoo import Bert
        env = get_environment()
        env.allow_bfloat16()
        # the embedding's backward accumulates by atomics unless asked not to:
        # a bitwise comparison needs the deterministic kernels
        torch.use_deterministic_algorithms(True, warn_only=True)
        devs = [str(self.device)] * PAR_WAYS
        try:
            init = Bert.base(dropout_rate=0.0).init(device=self.device).params()
            own_l, _, own, _, _, _ = self.par_bert_fit(init, None)
            own_w = [t.detach().clone() for t in tree_leaves(own.params())]
            del own
            plans = {
                "data_parallel": (lambda: ParallelPlan.data_parallel(create_mesh(devices_=devs)),
                                  lambda: ParallelPlan.compose(data=PAR_WAYS, devices_=devs)),
                "fsdp": (lambda: ParallelPlan.fsdp(create_mesh(devices_=devs)),
                         lambda: ParallelPlan.compose(fsdp=PAR_WAYS, devices_=devs)),
                "tensor_parallel": (lambda: ParallelPlan.tensor_parallel(create_mesh(
                    {"data": 1, "model": PAR_WAYS}, devices_=devs)),
                                    lambda: ParallelPlan.compose(tensor=PAR_WAYS, devices_=devs))}
            for kind, (factory, composed) in plans.items():
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                losses, stamps, net, pw, counts, wall = self.par_bert_fit(init, factory())
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                want = PAR_WAYS * BERT_LAYERS * PAR_STEPS
                self.check(all(v == want for v in counts.values()),
                           f"parallel {kind}: flash launches over {PAR_STEPS} steps {counts} "
                           f"(expected {want} each: {PAR_WAYS} x 12 a step)")
                self.add_launches({c.name: counts[c.name] for c in (
                    fa.lse_counter, fa.bwd_dq_counter, fa.bwd_dkv_counter)})
                step_ms = sorted(1e3 * (b - a) for a, b in zip(stamps[1:], stamps[2:]))
                med = step_ms[len(step_ms) // 2]
                log(f"parallel {kind} ({PAR_WAYS} x {self.device}, {self.card}): "
                    f"{PAR_STEPS} steps of B={BERT_B} T={BERT_T} bf16 in {wall:.3f} s; step ms "
                    f"after the first: median {med:.2f} (min {step_ms[0]:.2f}, max "
                    f"{step_ms[-1]:.2f}); {BERT_B / med * 1e3:.0f} samples/s; first step "
                    f"{1e3 * (stamps[1] - stamps[0]):.1f} ms; peak memory "
                    f"{peak:.2f} GiB; losses " + " ".join(f"{v:.4f}" for v in losses))
                finite = len(losses) == PAR_STEPS and all(np.isfinite(v) for v in losses)
                self.check(finite, f"parallel {kind}: {PAR_STEPS} finite losses")
                weights = [t.detach().clone() for t in tree_leaves(net.params())]
                if kind == "data_parallel":
                    err = max(abs(a - b) for a, b in zip(losses, own_l))
                    werr = max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(tree_leaves(net.params()), own_w))
                    self.check(err <= BERT_TRAIN_TOL["bfloat16"] and werr <= PAR_WEIGHT_TOL,
                               f"parallel data_parallel vs the net's own fit: losses "
                               f"max_abs_err={err:.3g} (tol {BERT_TRAIN_TOL['bfloat16']:g}), "
                               f"weights max_abs_err={werr:.3g} (tol {PAR_WEIGHT_TOL:g}); own "
                               + " ".join(f"{v:.4f}" for v in own_l))
                    x = pw.model  # one more step, replayed, under the profiler
                    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
                    from deeplearning4j_tpu_torch.imports.tf_oracles import bert_synthetic_batch
                    ids, _, mask, labels = bert_synthetic_batch(BERT_B, BERT_T, BERT_VOCAB, seed=1)
                    one = ListDataSetIterator([DataSet(ids, labels,
                                                       features_mask=mask.astype("float32"))])
                    x.set_listeners()
                    self.device_breakdown(lambda: pw.fit(one), f"parallel {kind} step", reps=3,
                                          step_ms=med)
                del net, pw
                torch.cuda.empty_cache()
                l2, _, net2, _, _, _ = self.par_bert_fit(init, composed())
                same = l2 == losses and all(
                    bool(torch.equal(a, b)) for a, b in zip(weights, tree_leaves(net2.params())))
                self.check(same, f"parallel compose twin of {kind}: losses and weights bit for "
                                 f"bit ({' '.join(f'{v:.4f}' for v in l2)})")
                del net2, weights
        finally:
            torch.use_deterministic_algorithms(False)
            env.set_compute_dtype("float32")
            torch.cuda.empty_cache()

    def parallel_pipe(self):
        """bench_parallel's net over 8 x cuda:0: compose(data=2, pipe=4) at
        microbatches 1 bit for bit against data=2, at 4 within
        PAR_PIPE_TOL."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.data import NumpyDataSetIterator
        from deeplearning4j_tpu_torch.models import MultiLayerNetwork
        from deeplearning4j_tpu_torch.nn import (DenseLayer, InputType, NeuralNetConfiguration,
                                                 OutputLayer)
        from deeplearning4j_tpu_torch.parallel import ParallelPlan, ParallelWrapper
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.runtime.mesh import MeshSpec, create_mesh
        from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
        from deeplearning4j_tpu_torch.train import Sgd
        get_environment().set_compute_dtype("float32")
        b = NeuralNetConfiguration.builder().seed(7).updater(Sgd(0.05)).list()
        for _ in range(5):
            b = b.layer(DenseLayer(n_out=64, activation="tanh"))
        conf = (b.layer(OutputLayer(n_out=8, activation="softmax"))
                .set_input_type(InputType.feed_forward(32)).build())
        rng = np.random.default_rng(20)
        n = 64 * PAR_PIPE_STEPS
        X = rng.normal(0, 1, (n, 32)).astype(np.float32)
        Y = np.eye(8, dtype=np.float32)[rng.integers(0, 8, n)]
        devs = [str(self.device)] * 8

        def run(plan):
            net = MultiLayerNetwork(conf, device=self.device).init()
            pw = ParallelWrapper(net, plan, prefetch_buffer=0)
            pw.fit(NumpyDataSetIterator(X, Y, batch_size=64))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pw.fit(NumpyDataSetIterator(X, Y, batch_size=64))
            torch.cuda.synchronize()
            sps = PAR_PIPE_STEPS / (time.perf_counter() - t0)
            return torch.cat([t.detach().reshape(-1) for t in tree_leaves(net.params())]), sps

        ref, ref_sps = run(ParallelPlan.data_parallel(create_mesh(MeshSpec({"data": 2}),
                                                                  devices_=devs[:2])))
        m1, m1_sps = run(ParallelPlan.compose(data=2, pipe=4, microbatches=1, devices_=devs))
        m4, m4_sps = run(ParallelPlan.compose(data=2, pipe=4, microbatches=4, devices_=devs))
        log(f"parallel pipe ({self.card}): steps/s (2 fits of {PAR_PIPE_STEPS} batches of 64, "
            f"the second timed) data=2 {ref_sps:.1f}, data=2 x pipe=4 microbatches 1 "
            f"{m1_sps:.1f}, microbatches 4 {m4_sps:.1f}")
        self.check(bool(torch.equal(ref, m1)),
                   "parallel pipe: compose(data=2, pipe=4, microbatches=1) bit for bit "
                   "against data=2")
        err = float((ref - m4).abs().max())
        self.check(bool(torch.allclose(m4, ref, **PAR_PIPE_TOL)),
                   f"parallel pipe: microbatches=4 against data=2, max_abs_err={err:.3g} "
                   f"(rtol {PAR_PIPE_TOL['rtol']:g}, atol {PAR_PIPE_TOL['atol']:g})")

    def parallel_distributed(self, workdir):
        """bench_distributed's shape: world-2 loopback, then two gloo
        processes computing on cuda:0, at threshold 0 and 1e-3 (bit for bit
        against loopback; encoded bytes >= PAR_DIST_MIN_RATIO x smaller);
        then world-2 loopback on BERT-base at 1e-3."""
        import hashlib

        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.models import MultiLayerNetwork
        from deeplearning4j_tpu_torch.nn import (DenseLayer, InputType, NeuralNetConfiguration,
                                                 OutputLayer)
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
        from deeplearning4j_tpu_torch.train import Sgd
        from deeplearning4j_tpu_torch.train.distributed import (DistributedConfig,
                                                                DistributedSupervisor,
                                                                DistributedTrainer,
                                                                kill_stray_workers)
        from deeplearning4j_tpu_torch.zoo import Bert
        env = get_environment()
        env.set_compute_dtype("float32")
        conf = (NeuralNetConfiguration.builder().seed(7).updater(Sgd(0.1)).list()
                .layer(DenseLayer(n_out=PAR_DIST_HIDDEN, activation="relu"))
                .layer(OutputLayer(n_out=8, activation="softmax"))
                .set_input_type(InputType.feed_forward(PAR_DIST_FEATURES)).build())
        B = 2 * PAR_DIST_LOCAL_B

        def loopback(threshold):
            net = MultiLayerNetwork(conf, device=self.device).init()
            tr = DistributedTrainer(net, DistributedConfig(threshold=threshold), world=2,
                                    rank=None)
            for i in range(PAR_DIST_STEPS + 2):
                brng = np.random.default_rng(1000 + i)
                tr.step(brng.normal(0, 1, (B, PAR_DIST_FEATURES)).astype(np.float32),
                        np.eye(8, dtype=np.float32)[brng.integers(0, 8, B)])
            h = hashlib.sha256()
            for t in tree_leaves(net.params()):
                h.update(t.detach().cpu().numpy().tobytes())
            return tr.losses, h.hexdigest()

        wfile = os.path.join(workdir, "dist_worker.py")
        with open(wfile, "w") as f:
            f.write(DIST_WORKER)
        try:
            for threshold in (0.0, 1e-3):
                oracle_l, oracle_h = loopback(threshold)
                sup = DistributedSupervisor(
                    lambda rank, port: [sys.executable, wfile, str(rank), "2", port,
                                        str(threshold), str(PAR_DIST_STEPS),
                                        str(PAR_DIST_LOCAL_B), str(PAR_DIST_FEATURES),
                                        str(PAR_DIST_HIDDEN)],
                    num_processes=2, heartbeat_files=[], max_restarts=0)
                t0 = time.perf_counter()
                outs = sup.run(round_timeout_s=240)
                wall = time.perf_counter() - t0
                res = []
                for out, err in outs:
                    line = [l for l in out.splitlines() if l.startswith("RES")]
                    self.check(bool(line), f"parallel distributed worker result "
                                           f"({(out + err)[-600:]!r})")
                    if line:
                        res.append(json.loads(line[0][3:]))
                if len(res) != 2:
                    continue
                rep = res[0]["report"]
                ratio = rep["dense_bytes_per_step"] / max(1.0, rep["comms_bytes_per_step"])
                log(f"parallel distributed threshold={threshold:g} (2 processes on "
                    f"{self.device} over gloo, {self.card}): {res[0]['steps_per_sec']:.2f} "
                    f"steps/s of global batch {B}; encode {rep['encode_mean_ms']:.3f} ms, "
                    f"exchange {rep['exchange_mean_ms']:.3f} ms, decode "
                    f"{rep['decode_mean_ms']:.3f} ms, apply {rep['apply_mean_ms']:.3f} ms a "
                    f"step; {rep['comms_bytes_per_step']:.0f} bytes a step on the wire against "
                    f"{rep['dense_bytes_per_step']:.0f} dense ({ratio:.2f}x); group wall "
                    f"{wall:.1f} s with start-up")
                self.check(res[0]["losses"] == res[1]["losses"] == oracle_l
                           and res[0]["phash"] == res[1]["phash"] == oracle_h,
                           f"parallel distributed threshold={threshold:g}: both processes bit "
                           f"for bit against the loopback oracle "
                           f"({' '.join(f'{v:.4f}' for v in oracle_l[:3])} ...)")
                if threshold > 0:
                    self.check(ratio >= PAR_DIST_MIN_RATIO,
                               f"parallel distributed: encoded bytes {ratio:.2f}x smaller than "
                               f"dense (must be >= {PAR_DIST_MIN_RATIO:g})")
        finally:
            kill_stray_workers()

        # the codec at 110M parameters: BERT-base, world-2 loopback
        from deeplearning4j_tpu_torch.imports.tf_oracles import bert_synthetic_batch
        env.allow_bfloat16()
        try:
            net = MultiLayerNetwork(Bert.base(dropout_rate=0.0).conf(), device=self.device).init()
            tr = DistributedTrainer(net, DistributedConfig(threshold=1e-3), world=2, rank=None)
            ids, _, _, labels = bert_synthetic_batch(BERT_B, BERT_T, BERT_VOCAB, seed=1)
            tr.step(ids, labels)  # rank 0 warms up, rank 1 captures
            torch.cuda.synchronize()
            tr.reset_stats()
            t0 = time.perf_counter()
            for _ in range(PAR_DIST_BERT_STEPS):
                tr.step(ids, labels)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rep = tr.stats.report()
            log(f"parallel distributed Bert.base() world 2 loopback threshold 1e-3 "
                f"({self.card}): {PAR_DIST_BERT_STEPS} steps after the capture in {wall:.2f} s; "
                f"{net.num_params()} parameters; encode {rep['encode_mean_ms']:.1f} ms a rank "
                f"(2 a step), decode {rep['decode_mean_ms']:.1f} ms and apply "
                f"{rep['apply_mean_ms']:.1f} ms a step; {rep['comms_bytes_per_step']:.0f} bytes a step "
                f"against {rep['dense_bytes_per_step']:.0f} dense; losses "
                + " ".join(f"{v:.4f}" for v in tr.losses))
            self.check(len(tr.losses) == PAR_DIST_BERT_STEPS + 1
                       and all(np.isfinite(v) for v in tr.losses),
                       f"parallel distributed Bert.base(): {PAR_DIST_BERT_STEPS} finite losses")
            del net, tr
        finally:
            env.set_compute_dtype("float32")
            torch.cuda.empty_cache()

    def parallel_ring(self):
        """sequence_parallel_attention over seq=4 x cuda:0 at PAR_RING_SHAPE
        bf16 against a dense fp32 softmax."""
        torch = self.torch
        from deeplearning4j_tpu_torch.parallel import sequence_parallel_attention
        from deeplearning4j_tpu_torch.runtime.mesh import create_mesh
        mesh = create_mesh({"seq": 4}, devices_=[str(self.device)] * 4)
        g = torch.Generator(device=self.device).manual_seed(11)
        q, k, v = (torch.randn(PAR_RING_SHAPE, generator=g, device=self.device,
                               dtype=torch.bfloat16) for _ in range(3))
        d = PAR_RING_SHAPE[-1]
        for causal in (False, True):
            out = sequence_parallel_attention(q, k, v, mesh, causal=causal)
            s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
            if causal:
                t = PAR_RING_SHAPE[2]
                s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool,
                                              device=self.device).tril(), float("-inf"))
            ref = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v.float())
            err = float((out.float() - ref).abs().max())
            del s, ref
            ms = cuda_ms(lambda: sequence_parallel_attention(q, k, v, mesh, causal=causal), 5)
            log(f"parallel ring attention causal={causal} at {PAR_RING_SHAPE} bf16 over seq=4 x "
                f"{self.device} ({self.card}): {ms:.2f} ms a call (CUDA events)")
            self.check(err <= PAR_RING_TOL and out.dtype == torch.bfloat16,
                       f"parallel ring attention causal={causal}: max_abs_err={err:.3g} against "
                       f"a dense fp32 softmax (tol {PAR_RING_TOL:g})")
        torch.cuda.empty_cache()

    # ------------------------------------------------------------------ zoo
    def zoo_phase(self, workdir):
        """The rest of config #2's family: YOLO2 trained through conv_stats
        and served, every other zoo CNN at its published size against the
        CPU, VGG16 transfer learning, the graph char-RNN against the
        network one, and ResNet-50 with and without remat."""
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        env = get_environment()
        t0 = time.perf_counter()
        try:
            for name, part in (("yolo2", self.zoo_yolo2),
                               ("cnns", lambda: self.zoo_cnns(workdir)),
                               ("transfer learning", self.zoo_transfer),
                               ("graph rnn", self.zoo_graph_rnn),
                               ("remat", self.zoo_remat)):
                self.phase(f"zoo {name}", part)
        finally:
            env.set_remat(False)
            env.allow_bfloat16()
        log(f"zoo: the phase took {time.perf_counter() - t0:.1f} s")

    def zoo_yolo2(self):
        """YOLO2 at the zoo's defaults trained by ``fit`` (bf16 over fp32
        weights) on one synthetic detection batch: the main path, counted,
        ZOO_YOLO_PAIRS conv_stats launches a step and nothing else, all of
        them ``conv_stats_wgmma_kernel``; step ms, img/s, peak memory, a
        device-busy breakdown and conv_stats' share; the loss falls, every
        BatchNormalization's statistics move; the first steps against the
        plain conv_stats; then served through ``ModelRegistry`` and decoded
        with ``activate_boxes``."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.models import ComputationGraph
        from deeplearning4j_tpu_torch.ops.kernels import conv_stats as cs
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.serving import ModelRegistry
        from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
        from deeplearning4j_tpu_torch.zoo import YOLO2
        from deeplearning4j_tpu_torch.zoo.yolo2 import synthetic_labels
        get_environment().allow_bfloat16()
        torch.cuda.empty_cache()
        zoo = YOLO2()
        t0 = time.perf_counter()
        net = ComputationGraph(yolo2_conf(zoo), device=self.device).init()
        torch.cuda.synchronize()
        pairs = net.fused_pairs
        log(f"zoo yolo2: YOLO2({zoo.num_classes} classes, {zoo.height}x{zoo.width}, "
            f"{len(zoo.anchors)} anchors, {net.conf.global_conf.updater.to_dict()}, gradients "
            f"renormalized per layer) init {time.perf_counter() - t0:.1f} s, "
            f"{net.num_params()} parameters, fused pairs {sorted(pairs.items())}")
        self.check(sorted(pairs) == ["c3b", "c4b", "c5b", "c5d", "c6b", "c6d", "pt_conv"],
                   f"zoo yolo2 fused 1x1 conv + BatchNormalization pairs: {sorted(pairs)} "
                   f"(expected the {ZOO_YOLO_PAIRS} of zoo/yolo2.py)")
        grid = zoo.height // 32
        rng = np.random.default_rng(5)
        x = torch.from_numpy(rng.normal(0, 1, (ZOO_YOLO_B, zoo.height, zoo.width, 3))
                             .astype(np.float32)).to(self.device).to(torch.bfloat16)
        y = torch.from_numpy(synthetic_labels(rng, ZOO_YOLO_B, grid, grid, zoo.anchors,
                                              zoo.num_classes)).to(self.device)
        state0 = clone_tree(net._model_state)
        snaps = []
        scores, stamps = CollectScoresListener(), []
        net.set_listeners(scores, StepStamps(stamps))
        counters = all_counters()

        # ---- the main path: counts from 0 just before, read just after
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        for i in range(ZOO_YOLO_STEPS):
            if i < ZOO_CMP_STEPS:
                snaps.append((clone_tree(net.params()), clone_tree(net._model_state)))
            net.fit(x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {c.name: c.value for c in counters}
        # ----
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = {c.name: 0 for c in counters}
        want[cs.counter.name] = ZOO_YOLO_PAIRS * ZOO_YOLO_STEPS
        self.check(counts == want, f"zoo yolo2 fit launch counts over {ZOO_YOLO_STEPS} steps: "
                                   f"{counts} (expected {ZOO_YOLO_PAIRS} conv_stats a step, "
                                   "nothing else)")
        self.add_launches(counts)
        losses = [v for _, v in scores.scores]
        tail = sum(losses[-3:]) / 3
        self.check(len(losses) == ZOO_YOLO_STEPS and all(np.isfinite(v) for v in losses)
                   and tail < losses[0],
                   f"zoo yolo2 bf16 loss on the repeated batch: first {losses[0]:.4f}, mean of "
                   f"the last 3 {tail:.4f} (must be below the first): "
                   + " ".join(f"{v:.4f}" for v in losses))
        moved = {name: max(float((net._model_state[name][k] - st[k]).abs().max())
                           for k in ("mean", "var")) for name, st in state0.items()}
        still = sorted(n for n, v in moved.items() if not v > 0.0)
        self.check(not still, f"zoo yolo2 running statistics of all {len(moved)} "
                              f"BatchNormalizations moved (least max |change| "
                              f"{min(moved.values()):.3g}); unmoved: {still}")
        step_ms = sorted(1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
        med = step_ms[len(step_ms) // 2]
        log(f"zoo yolo2 train: {ZOO_YOLO_STEPS} steps of batch {ZOO_YOLO_B} at "
            f"{zoo.height}x{zoo.width} bf16 in {wall:.3f} s; step ms after the first: median "
            f"{med:.2f} (min {step_ms[0]:.2f}, max {step_ms[-1]:.2f}); "
            f"{ZOO_YOLO_B / med * 1e3:.1f} img/s at the median; first step "
            f"{1e3 * (stamps[0] - t0):.1f} ms; peak memory {peak:.2f} GiB ({self.card})")
        net.set_listeners()
        per = self.device_breakdown(lambda: net.fit(x, y),
                                    f"zoo yolo2 fit step (batch {ZOO_YOLO_B})", reps=3,
                                    step_ms=med)
        for _ in range(3):  # a session that lost a launch is taken again
            new, old, ms = self.conv_stats_in(per)
            if new == ZOO_YOLO_PAIRS and old == 0:
                break
            per, _ = self.profile_kernels(lambda: net.fit(x, y), 1)
        busy = sum(t for t, _ in per.values())
        self.check(new == ZOO_YOLO_PAIRS and old == 0,
                   f"zoo yolo2 fit step: the profiler sees {new:g} conv_stats_wgmma_kernel and "
                   f"{old:g} conv_stats_kernel launches a step (expected {ZOO_YOLO_PAIRS} and 0)")
        log(f"zoo yolo2 fit step: conv_stats (tile and column-sum kernels) {ms:.3f} ms, "
            f"{100 * ms / max(busy, 1e-9):.1f}% of the step's device busy time {busy:.3f} ms "
            f"(profiler; {self.card})")

        # ---- serving: the trained net through the registry (the archive
        # route is the resnet phase's and the CPU tests')
        reg = ModelRegistry()
        served = reg.register("yolo2", net, max_batch_size=ZOO_SERVE_B)
        reqs = [rng.normal(0, 1, (ZOO_SERVE_B, zoo.height, zoo.width, 3)).astype(np.float32)
                for _ in range(4)]
        reg.predict("yolo2", reqs[0])  # warm-up
        for c in counters:
            c.reset()
        ms, answers = [], []
        for i in range(20):
            t_req = time.perf_counter()
            answers.append(reg.predict("yolo2", reqs[i % len(reqs)]))
            ms.append(1e3 * (time.perf_counter() - t_req))
        counts = {c.name: c.value for c in counters}
        ms.sort()
        p50 = ms[len(ms) // 2]
        log(f"zoo yolo2 serving (bf16): 20 sequential {ZOO_SERVE_B}-row requests: p50 "
            f"{p50:.2f} ms (min {ms[0]:.2f}, max {ms[-1]:.2f}), "
            f"{ZOO_SERVE_B / p50 * 1e3:.1f} img/s at p50 ({self.card})")
        self.check(all(v == 0 for v in counts.values()),
                   f"zoo yolo2 serving launches nothing of the port (inference runs the pairs "
                   f"unfused): {counts}")
        with torch.inference_mode():
            own = [net.output(r).float().cpu().numpy() for r in reqs]
        scale = max(float(np.abs(o).max()) for o in own)
        err = max(float(np.abs(np.asarray(a, np.float32) - own[i % len(reqs)]).max())
                  for i, a in enumerate(answers))
        self.check(err <= ZOO_SERVE_TOL * max(scale, 1.0)
                   and all(tuple(a.shape) == own[0].shape for a in answers),
                   f"zoo yolo2 20 answers served by the registry vs the trained net's own "
                   f"output: max_abs_err={err:.3g} on raw predictions of magnitude up to "
                   f"{scale:.3g}, tol={ZOO_SERVE_TOL:g} x max(1, magnitude)")
        head = net.conf.node("yolo").obj
        xy, wh, obj, cls = head.activate_boxes(torch.as_tensor(np.asarray(answers[0],
                                                                         np.float32)))
        a = len(zoo.anchors)
        shapes = [tuple(t.shape) for t in (xy, wh, obj, cls)]
        want_shapes = [(ZOO_SERVE_B, grid, grid, a, 2), (ZOO_SERVE_B, grid, grid, a, 2),
                       (ZOO_SERVE_B, grid, grid, a, 1), (ZOO_SERVE_B, grid, grid, a,
                                                         zoo.num_classes)]
        finite = all(bool(torch.isfinite(t).all()) for t in (xy, wh, obj, cls))
        self.check(shapes == want_shapes and finite
                   and float((cls.sum(-1) - 1).abs().max()) < 1e-4
                   and 0 <= float(obj.min()) and float(obj.max()) <= 1,
                   f"zoo yolo2 activate_boxes of one served batch: shapes {shapes}, finite "
                   f"{finite}, objectness in [{float(obj.min()):.3f}, {float(obj.max()):.3f}]")
        reg.shutdown()
        del net, served, reg
        torch.cuda.empty_cache()

        # ---- the kernel vs the plain version, at the weights of each of the
        # first ZOO_CMP_STEPS steps
        plain = ComputationGraph(yolo2_conf(zoo), device=self.device).init(params=snaps[0][0])
        plain_scores = CollectScoresListener()
        plain.set_listeners(plain_scores)
        with plain_conv_stats():
            for params, state in snaps:
                plain.set_params(params)
                plain._model_state = state
                plain.fit(x, y)
        want_l = [v for _, v in plain_scores.scores]
        got = losses[:ZOO_CMP_STEPS]
        err = max(abs(a - b) / max(abs(b), 1.0) for a, b in zip(got, want_l))
        self.check(err <= ZOO_YOLO_TOL,
                   f"zoo yolo2 bf16 losses of the first {ZOO_CMP_STEPS} steps, kernel "
                   f"{' '.join(f'{v:.5f}' for v in got)} vs plain conv_stats from the same "
                   f"weights {' '.join(f'{v:.5f}' for v in want_l)}: max relative err "
                   f"{err:.3g}, tol={ZOO_YOLO_TOL:g}")
        del plain, snaps, state0, x, y
        torch.cuda.empty_cache()

    def zoo_cnns(self, workdir):
        """Every other zoo CNN at its published input size: one forward and
        ZOO_CPU_STEPS ``fit`` steps at batch ZOO_CPU_B in fp32 on the card
        (the graphs' fused pairs through conv_stats, counted) against the
        same on the CPU from one archive, dropout retained at 1.0 in both
        (the two devices draw different masks); then the forward ms at
        batch ZOO_FWD_B in bf16."""
        import numpy as np
        torch = self.torch
        import deeplearning4j_tpu_torch.zoo as tzoo
        from deeplearning4j_tpu_torch.models import (ComputationGraph,
                                                     ComputationGraphConfiguration,
                                                     ModelSerializer, MultiLayerNetwork)
        from deeplearning4j_tpu_torch.ops.kernels import conv_stats as cs
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
        from deeplearning4j_tpu_torch.zoo.base import without_dropout
        from deeplearning4j_tpu_torch.zoo.yolo2 import synthetic_labels
        env = get_environment()
        counters = all_counters()
        rows = []
        for k, (name, size) in enumerate(ZOO_CNNS):
            t_model = time.perf_counter()
            env.set_compute_dtype("float32")
            torch.cuda.empty_cache()
            zoo = getattr(tzoo, name)(height=size, width=size)
            conf = without_dropout(zoo.conf())
            graph = isinstance(conf, ComputationGraphConfiguration)
            net = (ComputationGraph if graph else MultiLayerNetwork)(conf,
                                                                     device=self.device).init()
            path = os.path.join(workdir, f"{name}.zip")
            net.save(path)
            cpu = ModelSerializer.restore_model(path, device="cpu")
            rng = np.random.default_rng(100 + k)
            x = rng.normal(0, 1, (ZOO_CPU_B, size, size, 3)).astype(np.float32)
            want = cpu.output(x).numpy()
            got = net.output(x).float().cpu().numpy()
            out_err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
            if name == "TinyYOLO":
                g = want.shape[1]
                y = synthetic_labels(rng, ZOO_CPU_B, g, g, zoo.anchors, zoo.num_classes)
            elif name == "UNet":
                y = (rng.random(want.shape) > 0.5).astype(np.float32)
            else:
                y = np.eye(want.shape[-1], dtype=np.float32)[rng.integers(0, want.shape[-1],
                                                                          ZOO_CPU_B)]
            card_scores, cpu_scores = CollectScoresListener(), CollectScoresListener()
            net.set_listeners(card_scores)
            cpu.set_listeners(cpu_scores)
            pairs = len(getattr(net, "fused_pairs", {}))
            # ---- the main path: counts from 0 just before, read just after
            torch.cuda.synchronize()
            for c in counters:
                c.reset()
            for _ in range(ZOO_CPU_STEPS):
                net.fit(x, y)
            torch.cuda.synchronize()
            counts = {c.name: c.value for c in counters}
            # ----
            expect = {c.name: 0 for c in counters}
            expect[cs.counter.name] = pairs * ZOO_CPU_STEPS
            self.check(counts == expect, f"zoo {name} fp32 fit launch counts over "
                                         f"{ZOO_CPU_STEPS} steps: {counts} (expected {pairs} "
                                         "conv_stats a step, nothing else)")
            self.add_launches(counts)
            for _ in range(ZOO_CPU_STEPS):
                cpu.fit(x, y)
            a = [v for _, v in card_scores.scores]
            b = [v for _, v in cpu_scores.scores]
            loss_err = max(abs(u - v) / max(abs(v), 1e-30) for u, v in zip(a, b))
            judged, ok_loss = "", loss_err <= ZOO_CPU_TOL
            if (not ok_loss and name in ZOO_KINKED
                    and abs(a[0] - b[0]) <= ZOO_CPU_TOL * abs(b[0])):
                # a later step parted: judge both against the CPU in float64
                exact = self.zoo_float64_losses(path, x, y)
                dev = [max(abs(u - v) / abs(v) for u, v in zip(w, exact)) for w in (a, b)]
                judged = (f"; the float64 CPU steps {' '.join(f'{v:.6f}' for v in exact)}: "
                          f"card {dev[0]:.3g} from them, CPU fp32 {dev[1]:.3g}, must be within "
                          f"{ZOO_KINK_FACTOR}x the CPU's + {ZOO_CPU_TOL:g}")
                ok_loss = dev[0] <= ZOO_KINK_FACTOR * dev[1] + ZOO_CPU_TOL
            self.check(out_err <= ZOO_CPU_TOL and ok_loss and len(a) == len(b)
                       == ZOO_CPU_STEPS and all(np.isfinite(a)),
                       f"zoo {name} at {size}x{size}, {net.num_params()} parameters, fp32 card vs "
                       f"CPU from one archive: output max err {out_err:.3g} of its largest "
                       f"magnitude, losses card {' '.join(f'{v:.6f}' for v in a)} vs CPU "
                       f"{' '.join(f'{v:.6f}' for v in b)} (max relative err {loss_err:.3g}); "
                       f"tol {ZOO_CPU_TOL:g}{judged}")
            del cpu
            env.allow_bfloat16()
            gen = torch.Generator(device=self.device).manual_seed(k)
            xb = torch.randn(ZOO_FWD_B, size, size, 3, generator=gen,
                             device=self.device).to(torch.bfloat16)
            with torch.inference_mode():
                fwd = cuda_ms(lambda: net.output(xb), reps=5)
            rows.append((name, size, fwd))
            log(f"zoo {name}: {time.perf_counter() - t_model:.1f} s with the CPU's part")
            del net, xb
        torch.cuda.empty_cache()
        log(f"zoo forward ms at batch {ZOO_FWD_B} in bf16 ({self.card}): "
            + "; ".join(f"{n} {s}x{s} {ms:.2f} ms ({ZOO_FWD_B / ms * 1e3:.0f} img/s)"
                        for n, s, ms in rows))

    def zoo_float64_losses(self, path, x, y):
        """The ZOO_CPU_STEPS losses of the archive's net fitted on the CPU
        in float64, oneDNN off (its convolution backward is the less exact
        one): an ill-conditioned step's reference."""
        torch = self.torch
        from deeplearning4j_tpu_torch.models import ModelSerializer
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.runtime.trees import tree_map
        from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
        env = get_environment()
        saved = env.default_dtype, env.compute_dtype
        env.set_default_dtype("float64").set_compute_dtype("float64")
        try:
            ref = ModelSerializer.restore_model(path, device="cpu")
            ref.set_params(tree_map(lambda t: t.double(), ref.params()))
            scores = CollectScoresListener()
            ref.set_listeners(scores)
            with torch.backends.mkldnn.flags(enabled=False):
                for _ in range(ZOO_CPU_STEPS):
                    ref.fit(x, y)
        finally:
            env.default_dtype, env.compute_dtype = saved
        return [v for _, v in scores.scores]

    def zoo_transfer(self):
        """VGG16 (224, bf16) frozen up to its last hidden dense layer, its
        output replaced by a ZOO_TL_CLASSES-class OutputLayer (fine-tuned
        under Adam(1e-2)): ZOO_TL_STEPS steps at batch ZOO_TL_B, the loss
        falls and every frozen parameter is unchanged bit for bit."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.models import FineTuneConfiguration, TransferLearning
        from deeplearning4j_tpu_torch.nn import OutputLayer
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
        from deeplearning4j_tpu_torch.train.updaters import Adam
        from deeplearning4j_tpu_torch.zoo import VGG16
        get_environment().allow_bfloat16()
        torch.cuda.empty_cache()
        base = VGG16(height=ZOO_TL_HW, width=ZOO_TL_HW).init(device=self.device)
        last = max(i for i, l in enumerate(base.layers) if type(l).__name__ == "DenseLayer")
        net = (TransferLearning.builder(base)
               .fine_tune_configuration(FineTuneConfiguration(updater=Adam(1e-2)))
               .set_feature_extractor(last)
               .remove_output_layer()
               .add_layer(OutputLayer(n_out=ZOO_TL_CLASSES, activation="softmax",
                                      loss="mcxent"))
               .build())
        del base
        frozen_keys = [f"layer_{i}" for i, l in enumerate(net.layers) if l.frozen]
        frozen = {k: clone_tree(net.params()[k]) for k in frozen_keys if k in net.params()}
        self.check(len(frozen_keys) == last + 1 and not net.layers[-1].frozen,
                   f"zoo transfer: VGG16 layers 0..{last} frozen ({len(frozen)} with "
                   f"parameters), a new {ZOO_TL_CLASSES}-class head")
        rng = np.random.default_rng(21)  # host arrays: fit(x, y) takes them as a DataSet
        x = rng.normal(0, 1, (ZOO_TL_B, ZOO_TL_HW, ZOO_TL_HW, 3)).astype(np.float32)
        y = np.eye(ZOO_TL_CLASSES, dtype=np.float32)[rng.integers(0, ZOO_TL_CLASSES, ZOO_TL_B)]
        scores, stamps = CollectScoresListener(), []
        net.set_listeners(scores, StepStamps(stamps))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ZOO_TL_STEPS):
            net.fit(x, y)
        torch.cuda.synchronize()
        losses = [v for _, v in scores.scores]
        tail = sum(losses[-3:]) / 3
        same = [k for k, p in frozen.items()
                if all(torch.equal(p[n], net.params()[k][n]) for n in p)]
        step_ms = sorted(1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
        med = step_ms[len(step_ms) // 2]
        log(f"zoo transfer: {ZOO_TL_STEPS} steps of batch {ZOO_TL_B} bf16 in "
            f"{time.perf_counter() - t0:.2f} s, step ms after the first median {med:.2f} "
            f"({ZOO_TL_B / med * 1e3:.1f} img/s; {self.card})")
        self.check(all(np.isfinite(losses)) and tail < losses[0] and len(same) == len(frozen),
                   f"zoo transfer: loss {losses[0]:.4f} -> mean of the last 3 {tail:.4f} (must "
                   f"fall): {' '.join(f'{v:.4f}' for v in losses)}; frozen layers bit for bit "
                   f"unchanged: {len(same)} of {len(frozen)}")
        del net, frozen, x, y
        torch.cuda.empty_cache()

    def zoo_graph_rnn(self):
        """Config #3's char-RNN built as a ComputationGraph (bf16) from the
        MultiLayerNetwork char-RNN's weights: ``rnn_time_step`` in chunks
        against the whole sequence and against the network's
        ``rnn_time_step``; tBPTT ``fit`` against the network's; the main
        path counted (rows 3-4: the plain LSTM's inference, saving and
        backward kernels)."""
        import dataclasses
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.models import ComputationGraph, MultiLayerNetwork
        from deeplearning4j_tpu_torch.models.computation_graph import GraphBuilder
        from deeplearning4j_tpu_torch.nn import InputType, Layer
        from deeplearning4j_tpu_torch.ops.kernels import fused_lstm
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
        get_environment().allow_bfloat16()
        mconf = char_rnn_conf("lstm", ZOO_RNN_TBPTT)
        mln = MultiLayerNetwork(mconf, device=self.device).init()
        init = clone_tree(mln.params())
        g = GraphBuilder(dataclasses.replace(mconf.global_conf)).add_inputs("in")
        prev = "in"
        for i, layer in enumerate(mconf.layers):
            g.add_layer(f"layer_{i}", Layer.from_dict(layer.to_dict()), prev)
            prev = f"layer_{i}"
        conf = (g.set_outputs(prev).set_input_types(InputType.recurrent(VOCAB))
                .tbptt_fwd_length(ZOO_RNN_TBPTT).build())
        cg = ComputationGraph(conf, device=self.device).init(params=clone_tree(init))
        (x0, y0), (x1, y1) = char_batches(2, seed=31)
        x = torch.from_numpy(x0).to(self.device).to(torch.bfloat16)
        chunks = range(0, x.shape[1], ZOO_RNN_CHUNK)
        counters = all_counters()
        T = ZOO_RNN_TBPTT * ZOO_RNN_WINDOWS
        xt = np.concatenate([x0, x1], 1)[:, :T]
        yt = np.concatenate([y0, y1], 1)[:, :T]
        cg_scores = CollectScoresListener()
        cg.set_listeners(cg_scores)

        # ---- the main path: counts from 0 just before, read just after
        torch.cuda.synchronize()
        for c in counters:
            c.reset()
        whole = cg.output(x)
        parts = [cg.rnn_time_step(x[:, t:t + ZOO_RNN_CHUNK]) for t in chunks]
        cg.fit(xt, yt)
        torch.cuda.synchronize()
        counts = {c.name: c.value for c in counters}
        # ----
        want = {c.name: 0 for c in counters}
        want[fused_lstm.counter.name] = LAYERS * (1 + len(chunks))
        want[fused_lstm.save_counter.name] = LAYERS * ZOO_RNN_WINDOWS
        want[fused_lstm.bwd_counter.name] = LAYERS * ZOO_RNN_WINDOWS
        self.check(counts == want, f"zoo graph rnn launch counts (one whole-sequence output, "
                                   f"{len(chunks)} rnn_time_step chunks, {ZOO_RNN_WINDOWS} "
                                   f"tBPTT windows): {counts} (expected {want})")
        self.add_launches(counts)
        err = float((torch.cat(parts, 1).float() - whole.float()).abs().max())
        self.check(err <= CHUNK_TOL,
                   f"zoo graph rnn bf16 rnn_time_step in {len(chunks)} chunks of "
                   f"{ZOO_RNN_CHUNK} vs the whole sequence (B={x.shape[0]}, T={x.shape[1]}): "
                   f"max_abs_err={err:.3g} tol={CHUNK_TOL:g}")
        mparts = [mln.rnn_time_step(x[:, t:t + ZOO_RNN_CHUNK]) for t in chunks]
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(parts, mparts))
        self.check(err <= CHUNK_TOL,
                   f"zoo graph rnn rnn_time_step chunks vs the MultiLayerNetwork's: "
                   f"max_abs_err={err:.3g} tol={CHUNK_TOL:g}")
        mln_scores = CollectScoresListener()
        mln.set_listeners(mln_scores)
        mln.fit(xt, yt)
        got = [v for _, v in cg_scores.scores][:ZOO_CMP_STEPS]
        want_l = [v for _, v in mln_scores.scores][:ZOO_CMP_STEPS]
        err = max(abs(a - b) for a, b in zip(got, want_l))
        self.check(len(cg_scores.scores) == ZOO_RNN_WINDOWS and err <= TRAIN_TOL["bfloat16"],
                   f"zoo graph rnn bf16 tBPTT (length {ZOO_RNN_TBPTT}, {ZOO_RNN_WINDOWS} "
                   f"windows at B={TRAIN_B}): first {ZOO_CMP_STEPS} losses, graph "
                   f"{' '.join(f'{v:.5f}' for v in got)} vs network "
                   f"{' '.join(f'{v:.5f}' for v in want_l)}: max_abs_err={err:.3g} "
                   f"tol={TRAIN_TOL['bfloat16']:g}")
        del mln, cg

    def zoo_remat(self):
        """ResNet-50 as the resnet phase trains it, ZOO_REMAT_STEPS steps
        with ``set_remat(True)`` and as many without, from the same weights:
        peak memory, step ms, conv_stats launches a step (a fused pair in a
        recomputed segment launches again) and the losses."""
        torch = self.torch
        from deeplearning4j_tpu_torch.models import ComputationGraph
        from deeplearning4j_tpu_torch.ops.kernels import conv_stats as cs
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
        from deeplearning4j_tpu_torch.train.updaters import Nesterovs
        from deeplearning4j_tpu_torch.zoo import ResNet50
        env = get_environment()
        env.allow_bfloat16()
        torch.cuda.empty_cache()
        zoo = ResNet50(num_classes=RESNET_CLASSES, height=RESNET_HW, width=RESNET_HW,
                       updater=Nesterovs(0.1, momentum=0.9))
        init = clone_tree(zoo.init(device=self.device).params())
        g = torch.Generator(device=self.device).manual_seed(0)
        x = torch.randn(RESNET_B, RESNET_HW, RESNET_HW, 3, generator=g,
                        device=self.device).to(torch.bfloat16)
        labels = torch.randint(0, RESNET_CLASSES, (RESNET_B,), generator=g, device=self.device)
        y = torch.nn.functional.one_hot(labels, RESNET_CLASSES).float()
        counters = all_counters()
        runs = {}
        for remat in (False, True):
            env.set_remat(remat)
            net = ComputationGraph(zoo.conf(), device=self.device).init(params=clone_tree(init))
            segs = net._remat_segments()
            recomputed = sum(1 for k, seg in enumerate(segs) if 0 < len(seg) - 1
                             and k < len(segs) - 1 for n in seg if n in net.fused_pairs)
            scores, stamps = CollectScoresListener(), []
            net.set_listeners(scores, StepStamps(stamps))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for c in counters:
                c.reset()
            for _ in range(ZOO_REMAT_STEPS):
                net.fit(x, y)
            torch.cuda.synchronize()
            counts = {c.name: c.value for c in counters}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            self.add_launches(counts)
            step_ms = sorted(1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
            runs[remat] = ([v for _, v in scores.scores], step_ms[len(step_ms) // 2], peak,
                           counts[cs.counter.name] / ZOO_REMAT_STEPS, recomputed, len(segs))
            want = len(net.fused_pairs) + (recomputed if remat else 0)
            self.check(counts[cs.counter.name] == want * ZOO_REMAT_STEPS,
                       f"zoo remat={remat}: {counts[cs.counter.name] / ZOO_REMAT_STEPS:g} "
                       f"conv_stats launches a step (expected {len(net.fused_pairs)} pairs"
                       + (f" + {recomputed} recomputed in the backward pass" if remat else "")
                       + ")")
            del net
            torch.cuda.empty_cache()
        env.set_remat(False)
        (l0, ms0, peak0, n0, _, nseg), (l1, ms1, peak1, n1, rec, _) = runs[False], runs[True]
        err = max(abs(a - b) for a, b in zip(l0, l1))
        log(f"zoo remat: ResNet-50 batch {RESNET_B} bf16, {nseg} segments ({rec} fused pairs "
            f"recomputed): without remat step {ms0:.2f} ms, peak {peak0:.2f} GiB, {n0:g} "
            f"conv_stats a step; with remat step {ms1:.2f} ms, peak {peak1:.2f} GiB, {n1:g} "
            f"conv_stats a step ({self.card})")
        self.check(len(l0) == len(l1) == ZOO_REMAT_STEPS and err <= ZOO_REMAT_TOL,
                   f"zoo remat losses, without {' '.join(f'{v:.5f}' for v in l0)}, with "
                   f"{' '.join(f'{v:.5f}' for v in l1)}: max_abs_err={err:.3g} "
                   f"({'bit for bit' if l0 == l1 else 'not bit for bit'}), tol={ZOO_REMAT_TOL:g}")
        self.check(peak1 < peak0, f"zoo remat peak memory {peak1:.2f} GiB below "
                                  f"{peak0:.2f} GiB without")
        del x, y, init
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ serving
    def serving_phase(self, workdir):
        """Serving's device side at full width: BERT-base and two char-RNNs
        from replicas on captured CUDA graphs (2 parameter copies on cuda:0,
        2 batches in flight, warmed before traffic), sessions over the LSTM
        char-RNN, and the lifecycle (deadlines, admission, a chaos fault, the
        breaker, a hot-swap, a manifest replay, a resize, undeploy); each
        part a phase of its own."""
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        env = get_environment()
        try:
            for name, part in (("bert", lambda: self.serving_bert(workdir)),
                               ("graves", lambda: self.serving_char_rnn("graves", workdir)),
                               ("gru", lambda: self.serving_char_rnn("gru", workdir)),
                               ("sessions", lambda: self.serving_sessions(workdir)),
                               ("lifecycle", lambda: self.serving_lifecycle(workdir))):
                self.phase(f"serving {name}", part)
        finally:
            env.set_aot_dispatch(True)
            env.allow_bfloat16()

    @staticmethod
    def serve_clients(reg, name, reqs, timeout_ms=None):
        """One thread per list of ``reqs`` sending its requests in turn:
        ``(answers, latencies s, wall s, errors)``."""
        answers = [[None] * len(r) for r in reqs]
        lat, errors = [], []
        lock = threading.Lock()

        def client(c):
            for k, x in enumerate(reqs[c]):
                t0 = time.perf_counter()
                try:
                    answers[c][k] = reg.predict(name, x, timeout_ms=timeout_ms)
                except Exception as e:
                    with lock:
                        errors.append(e)
                    continue
                with lock:
                    lat.append(time.perf_counter() - t0)

        threads = [threading.Thread(target=client, args=(c,), name=f"smoke-serve-{c}")
                   for c in range(len(reqs))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            errors.append(RuntimeError("a client thread hung"))
        return answers, lat, wall, errors

    def serving_times(self, reg, name, x_full, conc, tag):
        """p50 of SERVING_SEQ sequential full-bucket requests, the device busy
        time of one (``torch.profiler``) and the host share (p50 less busy),
        and samples/s with p50/max latency of the concurrent requests
        ``conc``. Returns the numbers."""
        import numpy as np
        reg.predict(name, x_full)
        ms = []
        for _ in range(SERVING_SEQ):
            t0 = time.perf_counter()
            reg.predict(name, x_full)
            ms.append(1e3 * (time.perf_counter() - t0))
        p50 = float(np.median(ms))
        per, _ = self.profile_kernels(lambda: reg.predict(name, x_full), 5)
        busy = sum(t for t, _ in per.values())
        _, lat, wall, errors = self.serve_clients(reg, name, conc)
        rows = sum(x.shape[0] for r in conc for x in r)
        lat_ms = sorted(1e3 * v for v in lat)
        out = {"p50_ms": p50, "busy_ms": busy, "host_ms": p50 - busy,
               "host_share": (p50 - busy) / p50, "samples_s": rows / wall,
               "conc_p50_ms": lat_ms[len(lat_ms) // 2] if lat_ms else float("nan"),
               "conc_max_ms": lat_ms[-1] if lat_ms else float("nan")}
        self.check(not errors, f"{tag}: concurrent timing requests answered, errors={errors[:3]}")
        log(f"{tag}: one {x_full.shape[0]}-row request at a time, {SERVING_SEQ} requests: p50 "
            f"{p50:.3f} ms (min {min(ms):.3f}, max {max(ms):.3f}); device busy "
            f"{busy:.3f} ms a request (torch.profiler), host {p50 - busy:.3f} ms = "
            f"{100 * (p50 - busy) / p50:.1f}% of the p50; {SERVING_CONC[0]} clients x "
            f"{SERVING_CONC[1]} requests of 1-{x_full.shape[0]} rows ({rows} rows): "
            f"{rows / wall:.1f} samples/s, latency p50 {out['conc_p50_ms']:.3f} ms, max "
            f"{out['conc_max_ms']:.3f} ms [{self.card}]")
        return out

    def serving_exactness(self, reg, names, model, probe, pad_to, tag):
        """Bit-for-bit checks on sequential requests (each alone in its
        bucket): the first entry of ``names`` serves every request of
        ``probe`` twice (round robin: one on each replica), the others
        (depth 0) once; all must equal bit for bit, and are held against the
        model's eager ``output`` at the bucket shape (reported)."""
        import numpy as np
        first = reg.get(names[0])
        before = dict(first.metrics.snapshot()["replica_batches"])
        ans = [[reg.predict(names[0], x), reg.predict(names[0], x)] for x in probe]
        after = first.metrics.snapshot()["replica_batches"]
        moved = {r: after.get(r, 0) - before.get(r, 0) for r in after}
        self.check(sorted(moved.values()) == [len(probe)] * SERVING_REPLICAS,
                   f"{tag}: {len(probe)} sequential requests twice went to each of the "
                   f"{SERVING_REPLICAS} replicas once: batches per replica {moved}")
        same = all(arrays_equal(a, b) for a, b in ans)
        self.check(same, f"{tag}: answers bit for bit across the {SERVING_REPLICAS} replicas "
                         f"({len(probe)} requests of {[x.shape[0] for x in probe]} rows)")
        # full-bucket requests from 8 threads: each alone in its batch, both
        # replicas replaying at once with batches in flight, every answer the
        # sequential one bit for bit
        full = probe[-1]
        conc, _, _, errors = self.serve_clients(reg, names[0], [[full] * 3 for _ in range(8)])
        same = not errors and all(a is not None and arrays_equal(a, ans[-1][0])
                                  for r in conc for a in r)
        self.check(same, f"{tag}: 8 clients x 3 full-bucket requests, replicas replaying at "
                         f"once, bit for bit the sequential answer (errors={errors[:3]})")
        for other in names[1:]:
            got = [reg.predict(other, x) for x in probe]
            self.check(all(arrays_equal(g, a[0]) for g, a in zip(got, ans)),
                       f"{tag}: pipeline_depth {reg.get(other).batcher.pipeline_depth} "
                       f"({other}) bit for bit against depth {first.batcher.pipeline_depth}")
        worst, exact = 0.0, True
        for x, a in zip(probe, ans):
            n = x.shape[0]
            eager = model.output(pad_to(x, next(b for b in first.batcher.buckets if b >= n)))
            eager = eager.float().cpu().numpy()[:n]
            exact = exact and arrays_equal(eager, a[0])
            worst = max(worst, float(np.abs(eager - a[0]).max()))
        log(f"{tag}: replayed answers against the model's eager output at the bucket shape: "
            f"{'bit for bit' if exact else 'NOT bit for bit'}, max |difference| {worst:.3g}")
        self.check(exact, f"{tag}: replayed answers bit for bit against eager model.output at "
                          f"the bucket shape (max |difference| {worst:.3g})")
        return ans

    def serving_bert(self, workdir):
        """``Bert.base()`` bf16 from an archive through ``ModelRegistry.load``
        with a warm-up example, buckets 1-64, 2 replicas on cuda:0, 2 batches
        in flight: captures = buckets x replicas after warm-up and after
        traffic; 8 clients x 3 requests of 1-64 rows against the plain
        attention; 12 flash launches a batch through replays; bit for bit
        across replicas, against depth 0 and against eager ``output``; times
        beside the synchronous eager arm."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.serving import ModelRegistry
        env = get_environment()
        env.allow_bfloat16()
        path = self.bert_archive(workdir)
        rng = np.random.default_rng(2121)
        example = rng.integers(0, BERT_VOCAB, (1, BERT_T))
        reg = ModelRegistry()
        try:
            t0 = time.perf_counter()
            served = reg.load("bert", path, device=self.device, max_batch_size=BERT_B,
                              batch_timeout_ms=5.0, warmup_example=example,
                              devices=[self.device] * SERVING_REPLICAS, replicas=SERVING_REPLICAS,
                              pipeline_depth=SERVING_DEPTH, replay_manifest=False,
                              save_manifest=False)
            b = served.batcher
            pairs = len(b.buckets) * SERVING_REPLICAS
            log(f"serving bert: load + warm-up {time.perf_counter() - t0:.1f} s "
                f"(serving_warmup_seconds {served.metrics.snapshot().get('warmup_seconds')}), "
                f"buckets {b.buckets}, {b.replica_count} replicas, "
                f"{b._pool.state_bytes() / 1e6:.0f} MB of parameter copies")
            self.check(b.compile_count() == pairs,
                       f"serving bert: {b.compile_count()} graphs after warm-up (expected "
                       f"{len(b.buckets)} buckets x {SERVING_REPLICAS} replicas = {pairs})")
            rows = rng.integers(1, BERT_B + 1, (CLIENTS, REQUESTS_PER_CLIENT))
            rows[0, 0], rows[1, 0] = 1, BERT_B
            reqs = [[rng.integers(0, BERT_VOCAB, (int(n), BERT_T)) for n in r] for r in rows]
            counters = all_counters()
            batches0, replays0 = b.batches, aot_replays()
            # ---- the main path: counts from 0 just before, read just after
            torch.cuda.synchronize()
            for c in counters:
                c.reset()
            answers, lat, wall, errors = self.serve_clients(reg, "bert", reqs)
            torch.cuda.synchronize()
            counts = {c.name: c.value for c in counters}
            # ----
            batches, replays = b.batches - batches0, aot_replays() - replays0
            self.check(not errors, f"serving bert: {len(lat)} requests answered, "
                                   f"errors={errors[:3]}")
            self.check(replays == batches,
                       f"serving bert: {replays} graph replays over the traffic's {batches} "
                       f"batches (one each: no batch ran eagerly)")
            want = {c.name: 0 for c in counters}
            want[fa.counter.name] = BERT_LAYERS * batches
            self.check(counts == want,
                       f"serving bert: launches over the traffic {counts[fa.counter.name]} "
                       f"{fa.counter.name} through replays (expected {BERT_LAYERS} x {batches} "
                       f"batches), nothing else: {counts}")
            self.add_launches({fa.counter.name: counts[fa.counter.name]})
            self.check(b.compile_count() == pairs,
                       f"serving bert: {b.compile_count()} graphs after traffic (nothing "
                       f"captured on live traffic; expected {pairs})")
            model = served.model
            worst = 0.0
            with plain_attention():
                for c in range(CLIENTS):
                    for k, x in enumerate(reqs[c]):
                        got, n = answers[c][k], x.shape[0]
                        bucket = next(bk for bk in b.buckets if bk >= n)
                        padded = np.zeros((bucket, BERT_T), x.dtype)
                        padded[:n] = x
                        ref = model.output(padded).float().cpu().numpy()[:n]
                        ok = got is not None and got.shape == (n, 2) and \
                            bool(np.isfinite(got).all())
                        worst = max(worst, float(np.abs(got - ref).max()) if ok else float("inf"))
            self.check(worst <= BERT_TOL,
                       f"serving bert: {CLIENTS * REQUESTS_PER_CLIENT} answers vs the plain "
                       f"attention's forward: max_abs_err={worst:.3g} tol={BERT_TOL:g}")
            lat_ms = sorted(1e3 * v for v in lat)
            log(f"serving bert traffic: {len(lat)} requests, {int(rows.sum())} rows in "
                f"{wall:.3f} s over {batches} batches (buckets {b.bucket_counts}); latency p50 "
                f"{lat_ms[len(lat_ms) // 2]:.2f} ms, max {lat_ms[-1]:.2f} ms; "
                f"{rows.sum() / wall:.0f} samples/s [{self.card}]")

            def pad_ids(x, bucket):
                out = np.zeros((bucket, BERT_T), x.dtype)
                out[:x.shape[0]] = x
                return out

            reg.register("bert-d0", model, max_batch_size=BERT_B, batch_timeout_ms=5.0,
                         warmup_example=example, devices=[self.device], pipeline_depth=0)
            probe = [rng.integers(0, BERT_VOCAB, (n, BERT_T))
                     for n in (1, 7, BERT_B // 2 + 1, BERT_B)]
            self.serving_exactness(reg, ["bert", "bert-d0"], model, probe, pad_ids,
                                   "serving bert")
            reg.undeploy("bert-d0")
            # times: the pipelined graphs beside the synchronous eager arm
            conc = [[rng.integers(0, BERT_VOCAB, (int(n), BERT_T))
                     for n in rng.integers(1, BERT_B + 1, SERVING_CONC[1])]
                    for _ in range(SERVING_CONC[0])]
            x_full = rng.integers(0, BERT_VOCAB, (BERT_B, BERT_T))
            graphs = self.serving_times(reg, "bert", x_full, conc,
                                        f"serving bert graphs (depth {SERVING_DEPTH}, "
                                        f"{SERVING_REPLICAS} replicas)")
            reg.register("bert-sync", model, max_batch_size=BERT_B, batch_timeout_ms=5.0,
                         devices=[self.device], pipeline_depth=0)
            env.set_aot_dispatch(False)
            try:
                eager = self.serving_times(reg, "bert-sync", x_full, conc,
                                           "serving bert A/B arm (depth 0, aot_dispatch off, "
                                           "1 replica)")
            finally:
                env.set_aot_dispatch(True)
            log(f"serving bert A/B: p50 {graphs['p50_ms']:.3f} vs {eager['p50_ms']:.3f} ms, "
                f"host {graphs['host_ms']:.3f} vs {eager['host_ms']:.3f} ms "
                f"({100 * graphs['host_share']:.1f}% vs {100 * eager['host_share']:.1f}%), "
                f"{graphs['samples_s']:.1f} vs {eager['samples_s']:.1f} samples/s [{self.card}]")
            self.check(b.compile_count() == pairs,
                       f"serving bert: {b.compile_count()} graphs after every run (expected "
                       f"{pairs})")
        finally:
            reg.shutdown()

    def serving_char_rnn(self, cell, workdir):
        """The char-RNN of ``cell`` served as BERT is: from an archive with a
        warm-up example, buckets 1-64, 2 replicas on cuda:0, 2 in flight;
        answers against the plain forward, 2 launches a batch through
        replays, bit for bit across replicas, depth 0 and eager ``output``;
        times (beside the synchronous eager arm for GravesLSTM)."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.models import ModelSerializer, MultiLayerNetwork
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.serving import ModelRegistry
        env = get_environment()
        env.allow_bfloat16()
        tag = f"serving {CHAR_RNN_TAGS[cell]}"
        kernel = self.cell_module(CHAR_RNN_KERNELS[cell])
        net = MultiLayerNetwork(char_rnn_conf(cell, SERVE_T), device=self.device).init()
        path = os.path.join(workdir, f"serving-{cell}.zip")
        ModelSerializer.write_model(net, path)
        del net
        eye = np.eye(VOCAB, dtype=np.float32)
        rng = np.random.default_rng(CHAR_RNN_SEEDS[cell] + 77)
        ids = lambda n: eye[rng.integers(0, VOCAB, (int(n), SERVE_T))]  # noqa: E731
        reg = ModelRegistry()
        try:
            t0 = time.perf_counter()
            served = reg.load("char-rnn", path, device=self.device, max_batch_size=SERVE_B,
                              batch_timeout_ms=5.0, warmup_example=ids(1),
                              devices=[self.device] * SERVING_REPLICAS, replicas=SERVING_REPLICAS,
                              pipeline_depth=SERVING_DEPTH, replay_manifest=False,
                              save_manifest=False)
            b = served.batcher
            pairs = len(b.buckets) * SERVING_REPLICAS
            log(f"{tag}: load + warm-up {time.perf_counter() - t0:.1f} s")
            self.check(b.compile_count() == pairs,
                       f"{tag}: {b.compile_count()} graphs after warm-up (expected {pairs})")
            rows = rng.integers(1, SERVE_B + 1, (CLIENTS, REQUESTS_PER_CLIENT))
            rows[0, 0], rows[1, 0] = 1, SERVE_B
            reqs = [[ids(n) for n in r] for r in rows]
            counters = all_counters()
            batches0, replays0 = b.batches, aot_replays()
            # ---- the main path: counts from 0 just before, read just after
            torch.cuda.synchronize()
            for c in counters:
                c.reset()
            answers, lat, wall, errors = self.serve_clients(reg, "char-rnn", reqs)
            torch.cuda.synchronize()
            counts = {c.name: c.value for c in counters}
            # ----
            batches, replays = b.batches - batches0, aot_replays() - replays0
            self.check(not errors, f"{tag}: {len(lat)} requests answered, errors={errors[:3]}")
            self.check(replays == batches,
                       f"{tag}: {replays} graph replays over the traffic's {batches} batches "
                       f"(one each: no batch ran eagerly)")
            want = {c.name: 0 for c in counters}
            want[kernel.counter.name] = LAYERS * batches
            self.check(counts == want,
                       f"{tag}: launches over the traffic {counts[kernel.counter.name]} "
                       f"{kernel.counter.name} (expected {LAYERS} x {batches} batches), "
                       f"nothing else: {counts}")
            self.add_launches({kernel.counter.name: counts[kernel.counter.name]})
            self.check(b.compile_count() == pairs,
                       f"{tag}: {b.compile_count()} graphs after traffic (expected {pairs})")
            worst = 0.0
            for c in range(CLIENTS):
                for k, x in enumerate(reqs[c]):
                    got, n = answers[c][k], x.shape[0]
                    bucket = next(bk for bk in b.buckets if bk >= n)
                    padded = np.zeros((bucket,) + x.shape[1:], np.float32)
                    padded[:n] = x
                    ref = self.plain_forward(served.model, padded)[:n]
                    ok = got is not None and got.shape == (n, SERVE_T, VOCAB) and \
                        bool(np.isfinite(got).all())
                    worst = max(worst, float(np.abs(got - ref).max()) if ok else float("inf"))
            self.check(worst <= SERVE_TOL,
                       f"{tag}: {CLIENTS * REQUESTS_PER_CLIENT} answers vs the plain forward: "
                       f"max_abs_err={worst:.3g} tol={SERVE_TOL:g}")
            lat_ms = sorted(1e3 * v for v in lat)
            log(f"{tag} traffic: {len(lat)} requests in {wall:.3f} s over {batches} batches "
                f"(buckets {b.bucket_counts}); latency p50 {lat_ms[len(lat_ms) // 2]:.2f} ms, "
                f"max {lat_ms[-1]:.2f} ms [{self.card}]")

            def pad(x, bucket):
                out = np.zeros((bucket,) + x.shape[1:], x.dtype)
                out[:x.shape[0]] = x
                return out

            reg.register("char-rnn-d0", served.model, max_batch_size=SERVE_B,
                         batch_timeout_ms=5.0, warmup_example=ids(1), devices=[self.device],
                         pipeline_depth=0)
            self.serving_exactness(reg, ["char-rnn", "char-rnn-d0"], served.model,
                                   [ids(n) for n in (1, 5, SERVE_B // 2 + 1, SERVE_B)], pad, tag)
            reg.undeploy("char-rnn-d0")
            conc = [[ids(n) for n in rng.integers(1, SERVE_B + 1, SERVING_CONC[1])]
                    for _ in range(SERVING_CONC[0])]
            x_full = ids(SERVE_B)
            graphs = self.serving_times(reg, "char-rnn", x_full, conc,
                                        f"{tag} graphs (depth {SERVING_DEPTH}, "
                                        f"{SERVING_REPLICAS} replicas)")
            if cell == "graves":
                reg.register("char-rnn-sync", served.model, max_batch_size=SERVE_B,
                             batch_timeout_ms=5.0, devices=[self.device], pipeline_depth=0)
                env.set_aot_dispatch(False)
                try:
                    eager = self.serving_times(reg, "char-rnn-sync", x_full, conc,
                                               f"{tag} A/B arm (depth 0, aot_dispatch off, "
                                               f"1 replica)")
                finally:
                    env.set_aot_dispatch(True)
                log(f"{tag} A/B: p50 {graphs['p50_ms']:.3f} vs {eager['p50_ms']:.3f} ms, host "
                    f"{graphs['host_ms']:.3f} vs {eager['host_ms']:.3f} ms "
                    f"({100 * graphs['host_share']:.1f}% vs {100 * eager['host_share']:.1f}%), "
                    f"{graphs['samples_s']:.1f} vs {eager['samples_s']:.1f} samples/s "
                    f"[{self.card}]")
            expect = {CHAR_RNN_RAN[cell][0]: LAYERS}
            ran = self.recurrent_kernels(lambda: reg.predict("char-rnn", x_full), expect)
            self.check(ran == expect, f"{tag}: one replayed {SERVE_B}-row request ran {ran} by "
                                      f"the profiler (expected {expect})")
        finally:
            reg.shutdown()

    def serving_sessions(self, workdir):
        """``SessionStore`` over the LSTM char-RNN (2 replicas on cuda:0):
        SESSION_STREAMS concurrent streams of SESSION_STEPS steps, each
        stream bit for bit against a serial ``rnn_time_step`` loop padded to
        SESSION_BUCKET, 2 launches a step batch through replays, step p50."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.models import MultiLayerNetwork
        from deeplearning4j_tpu_torch.ops.kernels import fused_lstm
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.serving import ModelRegistry, SessionStore
        get_environment().allow_bfloat16()
        net = MultiLayerNetwork(char_rnn_conf("lstm", SERVE_T), device=self.device).init()
        eye = np.eye(VOCAB, dtype=np.float32)
        rng = np.random.default_rng(3131)
        chunks = {f"s{i}": [eye[rng.integers(0, VOCAB, (1, SESSION_T))]
                            for _ in range(SESSION_STEPS)] for i in range(SESSION_STREAMS)}
        reg = ModelRegistry()
        store = None
        try:
            served = reg.register("lstm", net, max_batch_size=SERVE_B,
                                  devices=[self.device] * SERVING_REPLICAS, replicas=SERVING_REPLICAS,
                                  pipeline_depth=SERVING_DEPTH, batch_timeout_ms=5.0)
            b = served.batcher
            b.enable_sessions(np.zeros((1, SESSION_T, VOCAB), np.float32),
                              session_bucket=SESSION_BUCKET)
            graphs = b.compile_count()
            self.check(graphs == SERVING_REPLICAS,
                       f"serving sessions: {graphs} session graphs after enable_sessions "
                       f"(expected one per replica: {SERVING_REPLICAS})")
            spill = os.path.join(workdir, "sessions")
            store = SessionStore(reg, spill, worker_id="smoke", start_evictor=False)
            for sid in chunks:
                store.create("lstm", session_id=sid)
            results = {sid: [] for sid in chunks}
            step_lat, errors = [], []
            lock = threading.Lock()

            def stream(sid):
                try:
                    for i, c in enumerate(chunks[sid]):
                        t0 = time.perf_counter()
                        out, step, replayed = store.step("lstm", sid, c, client_step=i)
                        with lock:
                            step_lat.append(time.perf_counter() - t0)
                        results[sid].append(out)
                except Exception as e:
                    errors.append((sid, e))

            threads = [threading.Thread(target=stream, args=(sid,), name=f"smoke-stream-{sid}")
                       for sid in chunks]
            counters = all_counters()
            b0, replays0 = b.metrics.snapshot()["batches_total"], aot_replays()
            # ---- the main path: counts from 0 just before, read just after
            torch.cuda.synchronize()
            for c in counters:
                c.reset()
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            counts = {c.name: c.value for c in counters}
            # ----
            step_batches = b.metrics.snapshot()["batches_total"] - b0
            replays = aot_replays() - replays0
            self.check(not errors and not any(t.is_alive() for t in threads),
                       f"serving sessions: {SESSION_STREAMS} streams x {SESSION_STEPS} steps "
                       f"answered, errors={errors[:3]}")
            self.check(replays == step_batches,
                       f"serving sessions: {replays} graph replays over {step_batches} step "
                       f"batches (one each: no step batch ran eagerly)")
            want = {c.name: 0 for c in counters}
            want[fused_lstm.counter.name] = LAYERS * step_batches
            self.check(counts == want,
                       f"serving sessions: {counts[fused_lstm.counter.name]} "
                       f"{fused_lstm.counter.name} launches (expected {LAYERS} x {step_batches} "
                       f"step batches), nothing else: {counts}")
            self.add_launches({fused_lstm.counter.name: counts[fused_lstm.counter.name]})
            self.check(b.compile_count() == graphs,
                       f"serving sessions: {b.compile_count()} graphs after the streams "
                       f"(expected {graphs}: nothing captured on traffic)")
            exact, worst = True, 0.0
            for sid, cs in chunks.items():
                net.rnn_clear_previous_state()
                for i, c in enumerate(cs):
                    xb = np.zeros((SESSION_BUCKET, SESSION_T, VOCAB), np.float32)
                    xb[0] = c[0]
                    want_out = net.rnn_time_step(xb).float().cpu().numpy()[:1]
                    got = results[sid][i] if i < len(results[sid]) else None
                    ok = got is not None and arrays_equal(got, want_out)
                    exact = exact and ok
                    if got is not None:
                        worst = max(worst, float(np.abs(got - want_out).max()))
            net.rnn_clear_previous_state()
            self.check(exact, f"serving sessions: every stream bit for bit against its serial "
                              f"rnn_time_step loop padded to {SESSION_BUCKET} rows (max "
                              f"|difference| {worst:.3g})")
            ms = sorted(1e3 * v for v in step_lat)
            log(f"serving sessions: {len(ms)} steps in {wall:.3f} s over {step_batches} step "
                f"batches ({len(ms) / max(1, step_batches):.1f} streams a batch); step p50 "
                f"{ms[len(ms) // 2]:.3f} ms, max {ms[-1]:.3f} ms; "
                f"{len(ms) * SESSION_T / wall:.0f} tokens/s [{self.card}]")
            snap = store.snapshot()
            self.check(snap["counters"]["steps_total"] == SESSION_STREAMS * SESSION_STEPS
                       and snap["spilled_files"] == SESSION_STREAMS,
                       f"serving sessions: store counters {snap['counters']}, "
                       f"{snap['spilled_files']} spill files")
        finally:
            if store is not None:
                store.shutdown(spill=False)
            reg.shutdown()

    def serving_lifecycle(self, workdir):
        """The rest of the lifecycle on the LSTM char-RNN (buckets 1-16, 2
        replicas on cuda:0): a 1 ms deadline, queue_limit 4 under a burst,
        a forward chaos fault, the breaker's open / half-open / closed, a
        hot-swap under 8 clients, a manifest saved and replayed by a fresh
        registry, add_replica/remove_replica under traffic, undeploy."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.models import ModelSerializer, MultiLayerNetwork
        from deeplearning4j_tpu_torch.ops.kernels import fused_lstm
        from deeplearning4j_tpu_torch.runtime.chaos import (AddLatency, ChaosController,
                                                            ChaosError, FailNth)
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.serving import (CircuitBreaker, CircuitOpen,
                                                      DeadlineExceeded, ModelRegistry,
                                                      Overloaded, RetryPolicy,
                                                      ServingShutdown, WarmupManifest,
                                                      manifest_path)
        get_environment().allow_bfloat16()
        eye = np.eye(VOCAB, dtype=np.float32)
        rng = np.random.default_rng(4141)
        ids = lambda n: eye[rng.integers(0, VOCAB, (int(n), SERVE_T))]  # noqa: E731
        conf = lambda: char_rnn_conf("lstm", SERVE_T)  # noqa: E731
        net = MultiLayerNetwork(conf(), device=self.device).init()
        path = os.path.join(workdir, "lifecycle.zip")
        ModelSerializer.write_model(net, path)
        dev2 = [self.device] * SERVING_REPLICAS
        kw = dict(max_batch_size=16, batch_timeout_ms=2.0, warmup_example=ids(1), devices=dev2,
                  replicas=SERVING_REPLICAS, pipeline_depth=SERVING_DEPTH)
        reg = ModelRegistry()
        reg2 = None
        try:
            served = reg.register("life", net, **kw)
            b = served.batcher
            pairs = b.compile_count()
            # a 1 ms deadline behind a slowed forward expires at coalesce
            with ChaosController() as c:
                c.on("serving.batcher.forward", AddLatency(0.05))
                parked = threading.Thread(target=lambda: reg.predict("life", ids(1)),
                                          name="smoke-parked")
                parked.start()
                time.sleep(0.01)
                try:
                    reg.predict("life", ids(1), timeout_ms=1.0)
                    err = None
                except DeadlineExceeded as e:
                    err = e
                parked.join(timeout=30)
            snap = b.metrics.snapshot()
            self.check(err is not None and "coalesce" in str(err)
                       and snap["rejected_deadline"] == 1,
                       f"lifecycle: a 1 ms deadline raised DeadlineExceeded ({err}); "
                       f"rejected_deadline={snap['rejected_deadline']}")
            # queue_limit=4 under a burst of 12: Overloaded with retry_after_ms
            reg.register("life-q", net, max_batch_size=1, batch_timeout_ms=1.0,
                         warmup_example=ids(1), devices=[self.device], pipeline_depth=1,
                         queue_limit=4)
            outcomes, hints = [], []
            lock = threading.Lock()

            def burst():
                try:
                    reg.predict("life-q", ids(1))
                    r = "ok"
                except Overloaded as e:
                    r = "overloaded"
                    hints.append(e.retry_after_ms)
                with lock:
                    outcomes.append(r)

            with ChaosController() as c:
                c.on("serving.batcher.forward", AddLatency(0.05))
                ths = [threading.Thread(target=burst, name=f"smoke-burst-{i}") for i in range(12)]
                for t in ths:
                    t.start()
                for t in ths:
                    t.join(timeout=60)
            self.check(len(outcomes) == 12 and "overloaded" in outcomes and "ok" in outcomes
                       and all(h is not None and h > 0 for h in hints),
                       f"lifecycle: queue_limit 4 under a burst of 12: {outcomes.count('ok')} "
                       f"served, {outcomes.count('overloaded')} Overloaded with retry_after_ms "
                       f"{[round(h, 2) for h in hints]}")
            reg.undeploy("life-q")
            # a forward chaos fault fails only its batch
            # (through the batcher: the registry's retry policy would absorb it)
            x = ids(2)
            r1 = b.submit(x)
            with ChaosController() as c:
                c.on("serving.batcher.forward", FailNth(2))
                a = b.submit(x)
                try:
                    b.submit(x)
                    failed = False
                except ChaosError:
                    failed = True
                r3 = b.submit(x)
            self.check(failed and arrays_equal(a, r1) and arrays_equal(r3, r1),
                       "lifecycle: a serving.batcher.forward fault failed only its batch (the "
                       "batches before and after it bit for bit)")
            # the breaker: open after its threshold, half-open after the reset, closed
            reg.register("life-b", net, max_batch_size=1, batch_timeout_ms=1.0,
                         warmup_example=ids(1), devices=[self.device],
                         breaker=CircuitBreaker(failure_threshold=2, reset_timeout_s=0.2),
                         retry=RetryPolicy(max_attempts=1))
            brk = reg.get("life-b").breaker
            states = [brk.state.name]
            with ChaosController() as c:
                c.on("serving.batcher.forward", FailNth(1, every=True))
                for _ in range(2):
                    try:
                        reg.predict("life-b", ids(1))
                    except ChaosError:
                        pass
                states.append(brk.state.name)
                try:
                    reg.predict("life-b", ids(1))
                    shed = False
                except CircuitOpen:
                    shed = True
            time.sleep(0.25)
            states.append(brk.state.name)
            reg.predict("life-b", ids(1))
            states.append(brk.state.name)
            self.check(shed and states == ["CLOSED", "OPEN", "HALF_OPEN", "CLOSED"],
                       f"lifecycle: breaker states {states}, shed while open: {shed}")
            reg.undeploy("life-b")
            # a hot-swap to v2 while 8 clients send: nothing fails, v2 captures
            # nothing on traffic
            reqs = [[ids(n) for n in rng.integers(1, 17, 6)] for _ in range(8)]
            swap = {}

            def hot_swap():
                time.sleep(0.02)
                v2 = reg.register("life", MultiLayerNetwork(conf(), device=self.device).init(),
                                  devices=dev2, replicas=SERVING_REPLICAS)
                swap["v2"], swap["graphs"] = v2, v2.batcher.compile_count()

            sw = threading.Thread(target=hot_swap, name="smoke-hot-swap")
            sw.start()
            _, _, _, errors = self.serve_clients(reg, "life", reqs)
            sw.join(timeout=120)
            v2 = swap.get("v2")
            after = [reg.predict("life", x) for r in reqs for x in r[:1]]
            self.check(not errors and v2 is not None and v2.version == 2
                       and swap["graphs"] == pairs and v2.batcher.compile_count() == pairs
                       and all(a_ is not None for a_ in after),
                       f"lifecycle: hot-swap to v{v2.version if v2 else '?'} under 8 clients: "
                       f"errors={errors[:3]}, v2 graphs {swap.get('graphs')} at the swap and "
                       f"{v2.batcher.compile_count() if v2 else '?'} after traffic (expected "
                       f"{pairs}); the replaced batcher stopped: "
                       f"{not b._worker.is_alive()}")
            # v2's graphs were captured while v1 replayed: each replay of them
            # counts its own launches and none of v1's
            counters = all_counters()
            batches0 = v2.batcher.batches if v2 is not None else 0
            torch.cuda.synchronize()
            for c in counters:
                c.reset()
            for r in reqs:
                reg.predict("life", r[0])
            torch.cuda.synchronize()
            counts = {c.name: c.value for c in counters}
            batches = v2.batcher.batches - batches0 if v2 is not None else 0
            want = {c.name: 0 for c in counters}
            want[fused_lstm.counter.name] = LAYERS * batches
            self.check(v2 is not None and counts == want,
                       f"lifecycle: after the hot-swap, {counts[fused_lstm.counter.name]} "
                       f"{fused_lstm.counter.name} launches over v2's {batches} batches "
                       f"(expected {LAYERS} a batch), nothing else: {counts}")
            # save_manifest, then a fresh registry replays it: exactly its pairs
            mpath = reg.save_manifest("life", path)
            manifest = WarmupManifest.load(manifest_path(path))
            reg2 = ModelRegistry()
            t0 = time.perf_counter()
            s2 = reg2.load("life", path, device=self.device, devices=dev2,
                           pipeline_depth=SERVING_DEPTH)
            replay_s = time.perf_counter() - t0
            got_pairs = s2.batcher.compile_count()
            self.serve_clients(reg2, "life", reqs)
            self.check(mpath is not None and got_pairs == len(manifest.pairs)
                       and s2.batcher.compile_count() == got_pairs
                       and s2.batcher.buckets == manifest.buckets,
                       f"lifecycle: manifest {os.path.basename(mpath or '?')} replayed by a fresh "
                       f"registry in {replay_s:.1f} s: {got_pairs} graphs for its "
                       f"{len(manifest.pairs)} pairs, {s2.batcher.compile_count()} after traffic")
            # add_replica / remove_replica under traffic capture nothing on traffic
            resize = {}

            def resizer():
                resize["add"] = s2.batcher.add_replica()
                resize["after_add"] = s2.batcher.compile_count()
                resize["remove"] = s2.batcher.remove_replica()
                resize["after_remove"] = s2.batcher.compile_count()

            rz = threading.Thread(target=resizer, name="smoke-resize")
            rz.start()
            _, _, _, errors = self.serve_clients(reg2, "life", reqs)
            rz.join(timeout=120)
            nb = len(s2.batcher.buckets)
            self.check(not errors and resize.get("add") == SERVING_REPLICAS + 1
                       and resize.get("after_add") == got_pairs + nb
                       and resize.get("remove") == SERVING_REPLICAS
                       and resize.get("after_remove") == got_pairs
                       and s2.batcher.compile_count() == got_pairs,
                       f"lifecycle: add_replica/remove_replica under traffic: {resize}, "
                       f"{s2.batcher.compile_count()} graphs after (expected {got_pairs}), "
                       f"errors={errors[:3]}")
            # undeploy drains: queued and in-flight requests are answered
            res = []

            def sender():
                try:
                    res.append(("ok", reg2.predict("life", ids(4))))
                except (KeyError, ServingShutdown) as e:
                    res.append((type(e).__name__, e))

            ths = [threading.Thread(target=sender, name=f"smoke-undeploy-{i}") for i in range(8)]
            with ChaosController() as c:
                c.on("serving.batcher.forward", AddLatency(0.02))
                for t in ths:
                    t.start()
                time.sleep(0.01)
                reg2.undeploy("life")
                for t in ths:
                    t.join(timeout=60)
            try:
                reg2.predict("life", ids(1))
                gone = False
            except KeyError:
                gone = True
            kinds = [k for k, _ in res]
            self.check(len(res) == 8 and kinds.count("ok") >= 1 and gone
                       and not s2.batcher._worker.is_alive(),
                       f"lifecycle: undeploy drained: {kinds}, predict after it KeyError={gone}")
        finally:
            reg.shutdown()
            if reg2 is not None:
                reg2.shutdown()

    # ------------------------------------------------------------ residency
    def residency_phase(self, workdir):
        """Serving's device side, second half: BERT-base paging under a
        budget, quantized deploys behind the gate and the three weight
        residencies' device bytes, int8 request rows on the char-RNNs, plan
        slices, ``ParallelInference``; each part a phase of its own."""
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        env = get_environment()
        env.allow_bfloat16()
        d = os.path.join(workdir, "residency")
        os.makedirs(d, exist_ok=True)
        try:
            self.phase("residency archives", lambda: self.residency_archives(workdir, d))
            for name, part in (("paging", lambda: self.residency_paging(d)),
                               ("quantized", lambda: self.residency_quantized(d)),
                               ("int8 rows", self.residency_rows),
                               ("plan", lambda: self.residency_plan(d)),
                               ("parallel inference", lambda: self.residency_inference(d))):
                self.phase(f"residency {name}", part)
        finally:
            env.set_aot_dispatch(True)
            env.allow_bfloat16()

    def residency_archives(self, workdir, d):
        """The paging drill's models: two ``Bert.base()`` archives of
        different seeds (the first the other phases' archive where it was
        written already) and a byte copy of each, m0-m3."""
        from deeplearning4j_tpu_torch.models import ModelSerializer
        from deeplearning4j_tpu_torch.zoo import Bert
        t0 = time.perf_counter()
        shared = os.path.join(workdir, "bert-base.zip")
        for i, seed in enumerate((123, RESIDENCY_SEED)):
            path = os.path.join(d, f"m{i}.zip")
            if seed == 123 and os.path.exists(shared):
                shutil.copyfile(shared, path)
            else:
                net = Bert.base(seed=seed).init(device=self.device)
                ModelSerializer.write_model(net, path)
                del net
            shutil.copyfile(path, os.path.join(d, f"m{i + 2}.zip"))
        log(f"residency archives: m0-m3 in {time.perf_counter() - t0:.1f} s "
            f"({os.path.getsize(os.path.join(d, 'm0.zip')) / 1e6:.0f} MB each)")

    def residency_kw(self):
        import numpy as np
        example = np.random.default_rng(2222).integers(0, BERT_VOCAB, (1, BERT_T))
        return dict(max_batch_size=BERT_B, buckets=list(RESIDENCY_BUCKETS),
                    batch_timeout_ms=5.0, replicas=1, devices=[self.device],
                    warmup_example=example)

    def allocated(self):
        """``torch.cuda.memory_allocated()`` once every queued kernel has run."""
        self.torch.cuda.synchronize()
        return self.torch.cuda.memory_allocated()

    def graph_pool_bytes(self):
        """Bytes the caching allocator holds in the CUDA graphs' private
        pools (the segments of ``torch.cuda.memory_snapshot()`` whose pool
        id is not the default pool's), or None where the snapshot does not
        say a segment's pool. What the graphs keep reserved; their
        intermediates, freed inside the capture, are not in
        ``memory_allocated``."""
        segments = self.torch.cuda.memory_snapshot()
        if segments and "segment_pool_id" not in segments[0]:
            return None
        return sum(int(seg["total_size"]) for seg in segments
                   if tuple(seg["segment_pool_id"]) != (0, 0))

    @staticmethod
    def at_bucket(batcher, x, bucket):
        """``x`` padded to ``bucket`` rows through the batcher's first replica
        (its graph at that bucket): the answer a batch of that bucket gives
        ``x``'s rows."""
        import numpy as np
        padded = np.zeros((bucket,) + x.shape[1:], x.dtype)
        padded[:x.shape[0]] = x
        pool = batcher._pool
        rep = pool.acquire()
        try:
            out = pool.dispatch(rep, padded).wait()
        finally:
            pool.release(rep)
        return out[:x.shape[0]]

    def residency_paging(self, d):
        """Four BERT-base names (two seeds, each twice) through
        ``load(resident=False)`` under a budget of 2.5 models; 3 threads x 8
        requests rotating over them: the ledger never over the budget, every
        answer bit for bit its model's at its bucket, page-ins capture only
        their manifest's pairs; a 30 ms deadline on a cold model; 5
        evict/page-in cycles of one model against ``memory_allocated``."""
        import gc

        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        from deeplearning4j_tpu_torch.runtime import compile_cache
        from deeplearning4j_tpu_torch.serving import ModelRegistry, PagingInProgress
        kw = self.residency_kw()
        paths = [os.path.join(d, f"m{i}.zip") for i in range(4)]
        rng = np.random.default_rng(2323)
        names = ["m0", "m1", "m2", "m3"]
        rows = rng.integers(1, BERT_B + 1, (RESIDENCY_CLIENTS, RESIDENCY_REQUESTS))
        reqs = [[rng.integers(0, BERT_VOCAB, (int(n), BERT_T)) for n in r] for r in rows]
        route = [[names[(c + k // 2) % 4] for k in range(RESIDENCY_REQUESTS)]
                 for c in range(RESIDENCY_CLIENTS)]
        # the answers before any eviction: each model at every bucket a
        # request may land in (alone, or coalesced with another thread's)
        probe = ModelRegistry()
        refs = {}
        try:
            for i in (0, 1):
                t0 = time.perf_counter()
                served = probe.load(f"m{i}", paths[i], device=self.device, **kw)
                dt = probe.residency_snapshot()["models"][f"m{i}"]["dtype_bytes"]
                log(f"residency paging: probe load of m{i} {time.perf_counter() - t0:.2f} s, "
                    f"ledger {served.device_bytes / 2**20:.1f} MiB "
                    f"{ {k: round(v / 2**20, 1) for k, v in sorted(dt.items())} } MiB")
                for c in range(RESIDENCY_CLIENTS):
                    for k, x in enumerate(reqs[c]):
                        if int(route[c][k][1]) % 2 == i:
                            refs[(c, k)] = [self.at_bucket(served.batcher, x, b)
                                            for b in kw["buckets"] if b >= x.shape[0]]
            one = probe.get("m0").device_bytes
            same = probe.get("m0").model.output(reqs[0][0]).float().cpu().numpy()
            other = probe.get("m1").model.output(reqs[0][0]).float().cpu().numpy()
        finally:
            probe.shutdown()
        self.check(not np.array_equal(same, other),
                   "residency paging: m0 and m1 (different seeds) answer differently")
        budget = int(RESIDENCY_BUDGET_MODELS * one)
        reg = ModelRegistry(hbm_budget_bytes=budget)
        try:
            for name, path in zip(names, paths):
                reg.load(name, path, resident=False, device=self.device, **kw)
            self.check(reg.resident_bytes() == 0 and reg.names() == names,
                       f"residency paging: 4 names registered cold, {reg.resident_bytes()} "
                       f"resident bytes")
            answers = [[None] * RESIDENCY_REQUESTS for _ in range(RESIDENCY_CLIENTS)]
            errors, peak = [], [0]
            lock = threading.Lock()

            def client(c):
                import traceback
                for k, x in enumerate(reqs[c]):
                    try:
                        answers[c][k] = reg.predict(route[c][k], x)
                    except Exception as e:
                        with lock:
                            if not errors:
                                log("residency paging: the first failed request:\n"
                                    + "".join(traceback.format_exception(e)))
                            errors.append(e)
                    r = reg.residency_snapshot()["resident_bytes"]
                    with lock:
                        peak[0] = max(peak[0], r)

            counters = all_counters()
            stats0 = compile_cache.stats()
            # ---- the main path: counts from 0 just before, read just after
            torch.cuda.synchronize()
            for c in counters:
                c.reset()
            t0 = time.perf_counter()
            ths = [threading.Thread(target=client, args=(c,), name=f"smoke-page-{c}")
                   for c in range(RESIDENCY_CLIENTS)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {c.name: c.value for c in counters}
            # ----
            stats1 = compile_cache.stats()
            captures = stats1["aot_compiles"] - stats0["aot_compiles"]
            replays = stats1["aot_replays"] - stats0["aot_replays"]
            pg = reg.paging.snapshot()
            self.check(not errors and not any(t.is_alive() for t in ths),
                       f"residency paging: {RESIDENCY_CLIENTS} x {RESIDENCY_REQUESTS} requests "
                       f"over 4 names answered, errors={errors[:3]}")
            self.check(peak[0] <= budget,
                       f"residency paging: resident bytes after every request at most "
                       f"{peak[0]} <= budget {budget} ({RESIDENCY_BUDGET_MODELS} x {one})")
            self.check(pg["page_ins_total"] >= 3 and pg["evictions_total"] >= 3,
                       f"residency paging: {pg['page_ins_total']} page-ins, "
                       f"{pg['evictions_total']} evictions (at least 3 each)")
            bad = [(c, k) for c in range(RESIDENCY_CLIENTS) for k in range(RESIDENCY_REQUESTS)
                   if answers[c][k] is None
                   or not any(np.array_equal(answers[c][k], r) for r in refs[(c, k)])]
            self.check(not bad, f"residency paging: every answer bit for bit its model's own "
                                f"at a bucket it may be served at, before any eviction "
                                f"(mismatches {bad[:5]})")
            pairs = len(kw["buckets"])
            self.check(captures == pairs * pg["page_ins_total"],
                       f"residency paging: {captures} graphs captured over the traffic = "
                       f"{pairs} manifest pairs x {pg['page_ins_total']} page-ins (nothing "
                       f"captured on traffic)")
            want = {c.name: 0 for c in counters}
            want[fa.counter.name] = BERT_LAYERS * (replays + captures)
            self.check(counts == want,
                       f"residency paging: {counts[fa.counter.name]} {fa.counter.name} "
                       f"launches = {BERT_LAYERS} x ({replays} replays + {captures} capture "
                       f"warm-ups), nothing else: {counts}")
            self.add_launches({fa.counter.name: counts[fa.counter.name]})
            snap = reg.residency_snapshot()
            page_in_s = sorted(m["page_in_s"] for m in snap["models"].values()
                               if m["page_in_s"])
            log(f"residency paging traffic: {RESIDENCY_CLIENTS * RESIDENCY_REQUESTS} requests "
                f"in {wall:.2f} s; {pg['page_ins_total']} page-ins (p50 "
                f"{1e3 * (pg['page_in_p50_s'] or 0):.0f} ms, p99 bucket "
                f"{1e3 * (pg['page_in_p99_s'] or 0):.0f} ms; per-model decayed "
                f"{[round(1e3 * s) for s in page_in_s]} ms), {pg['evictions_total']} "
                f"evictions, hit rate {reg.paging.hit_rate():.3f}, queue waits "
                f"{pg['page_in_queue_waits_total']}, peak ledger {peak[0] / 2**20:.1f} MiB of "
                f"{budget / 2**20:.1f} [{self.card}]")
            # a 30 ms deadline on a cold model while its page-in is under way
            cold = next(n for n in names if snap["models"][n]["state"] == "cold")
            # the registry's own estimate: the snapshot rounds it to 0.1 ms
            est_ms = 1e3 * (reg._residency[cold].page_in_s or 1.0)
            leader = {}

            def lead():
                try:
                    leader["out"] = reg.predict(cold, reqs[0][0])
                except Exception as e:
                    leader["err"] = e

            lt = threading.Thread(target=lead, name="smoke-page-leader")
            t0 = time.monotonic()
            lt.start()
            while cold not in reg._flights and time.monotonic() - t0 < 60:
                time.sleep(0.001)
            fl = reg._flights.get(cold)
            try:
                reg.predict(cold, reqs[0][0], timeout_ms=30.0)
                err = None
            except PagingInProgress as e:
                err = e
            elapsed_ms = 1e3 * (time.monotonic() - (fl.started_at if fl else t0))
            lt.join(timeout=120)
            self.check(err is not None and "err" not in leader
                       and err.retry_after_ms >= est_ms - elapsed_ms,
                       f"residency paging: a 30 ms deadline on cold {cold} got PagingInProgress "
                       f"retry_after_ms={getattr(err, 'retry_after_ms', None)} >= measured "
                       f"page-in {est_ms:.0f} ms less the {elapsed_ms:.0f} ms already spent; the "
                       f"leader answered ({leader.get('err')})")
            # RESIDENCY_CYCLES evict/page-in cycles of m0 alone
            for n in names:
                reg.evict(n)
            reg.page_in("m0")
            after, freed, evict_ms, page_ms, ledger = [], [], [], [], []
            for i in range(RESIDENCY_CYCLES):
                reg.predict("m0", reqs[0][0])
                ledger.append(reg.get("m0").device_bytes)
                before = self.allocated()
                t0 = time.perf_counter()
                reg.evict("m0")
                evict_ms.append(1e3 * (time.perf_counter() - t0))
                after.append(self.allocated())
                freed.append(before - after[-1])
                t0 = time.perf_counter()
                reg.page_in("m0")
                page_ms.append(1e3 * (time.perf_counter() - t0))
            reserved = torch.cuda.memory_reserved()
            self.check(all(f >= l for f, l in zip(freed, ledger)),
                       f"residency paging: each eviction freed {[f // 2**20 for f in freed]} "
                       f"MiB of memory_allocated >= the ledger's {ledger[0] // 2**20} MiB")
            self.check(abs(after[-1] - after[0]) <= RESIDENCY_LEAK,
                       f"residency paging: memory_allocated after the {RESIDENCY_CYCLES} "
                       f"evictions {[a // 2**20 for a in after]} MiB: the last within 16 MiB "
                       f"of the first ({(after[-1] - after[0]) / 2**20:+.2f} MiB); "
                       f"memory_reserved {reserved / 2**20:.0f} MiB")
            log(f"residency paging cycles: evict {[round(e, 1) for e in evict_ms]} ms, page-in "
                f"{[round(p) for p in page_ms]} ms (p50 {np.median(page_ms):.0f}, max "
                f"{max(page_ms):.0f}); ledger {ledger[0]} bytes against "
                f"{[f for f in freed]} freed [{self.card}]")
        finally:
            reg.shutdown()
            gc.collect()

    def residency_quantized(self, d):
        """``quantize_archive`` of m0 in both weight residencies (weights
        only: token ids are never int8 rows); each residency's ledger and
        ``memory_allocated`` with its graphs, p50 of 20 sequential 64-row
        requests, answers against the same model's forward built from the
        plain versions; the gate refusing (f32 serving on under 4 clients)
        and deploying."""
        import gc

        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        from deeplearning4j_tpu_torch.serving import ModelRegistry
        from deeplearning4j_tpu_torch.serving.quantize import (AccuracyGate,
                                                               AccuracyGateFailed,
                                                               quantize_archive)
        kw = self.residency_kw()
        m0 = os.path.join(d, "m0.zip")
        qpaths = {}
        for res in ("dequantized", "int8"):
            qpaths[res] = os.path.join(d, f"m0.{res}.zip")
            t0 = time.perf_counter()
            _, report = quantize_archive(m0, qpaths[res], None, weight_residency=res,
                                         quantized_buckets=[])
            log(f"residency quantized: quantize_archive ({res}) {time.perf_counter() - t0:.1f} "
                f"s: {report['weights_quantized']} of {report['leaves_total']} leaves int8, "
                f"{report['params_bytes_quantized'] / 2**20:.1f} MiB of "
                f"{report['params_bytes_f32'] / 2**20:.1f}, archive "
                f"{report['archive_bytes_dst'] / 1e6:.0f} MB")
        rng = np.random.default_rng(2424)
        probe = [rng.integers(0, BERT_VOCAB, (n, BERT_T)) for n in (1, 7, BERT_B // 2 + 1, BERT_B)]
        full = [rng.integers(0, BERT_VOCAB, (BERT_B, BERT_T)) for _ in range(SERVING_SEQ)]
        answers = {}
        for tag, path in (("f32", m0), ("dequantized", qpaths["dequantized"]),
                          ("int8", qpaths["int8"])):
            gc.collect()
            a0 = self.allocated()
            g0 = self.graph_pool_bytes()
            torch.cuda.reset_peak_memory_stats()
            reg = ModelRegistry()
            try:
                served = reg.load(tag, path, device=self.device, replay_manifest=False,
                                  save_manifest=False, **kw)
                a1 = self.allocated()
                g1 = self.graph_pool_bytes()
                peak = torch.cuda.max_memory_allocated()
                b = served.batcher
                counters = all_counters()
                batches0 = b.batches
                torch.cuda.synchronize()
                for c in counters:
                    c.reset()
                got = [reg.predict(tag, x) for x in probe]
                torch.cuda.synchronize()
                counts = {c.name: c.value for c in counters}
                batches = b.batches - batches0
                want = {c.name: 0 for c in counters}
                want[fa.counter.name] = BERT_LAYERS * batches
                self.check(counts == want,
                           f"residency quantized {tag}: {counts[fa.counter.name]} "
                           f"{fa.counter.name} over {batches} batches ({BERT_LAYERS} a batch), "
                           f"nothing else")
                self.add_launches({fa.counter.name: counts[fa.counter.name]})
                worst = 0.0
                with plain_attention():
                    for x, g in zip(probe, got):
                        n = x.shape[0]
                        bucket = next(bk for bk in b.buckets if bk >= n)
                        padded = np.zeros((bucket, BERT_T), x.dtype)
                        padded[:n] = x
                        ref = served.model.output(padded).float().cpu().numpy()[:n]
                        worst = max(worst, float(np.abs(g - ref).max()))
                self.check(worst <= BERT_TOL,
                           f"residency quantized {tag}: answers vs the same model's forward "
                           f"built from the plain versions: max_abs_err={worst:.3g} "
                           f"tol={BERT_TOL:g}")
                answers[tag] = [reg.predict(tag, x) for x in full[:4]]
                ms = []
                for x in full:
                    t0 = time.perf_counter()
                    reg.predict(tag, x)
                    ms.append(1e3 * (time.perf_counter() - t0))
                dt = reg.residency_snapshot()["models"][tag]["dtype_bytes"]
                pools = ("not measured" if g0 is None or g1 is None
                         else f"+{(g1 - g0) / 2**20:.1f} MiB")
                log(f"residency quantized {tag}: ledger {served.device_bytes / 2**20:.1f} MiB "
                    f"{ {k: round(v / 2**20, 1) for k, v in sorted(dt.items())} } MiB; "
                    f"memory_allocated +{(a1 - a0) / 2**20:.1f} MiB with its "
                    f"{b.compile_count()} graphs (peak during the load +"
                    f"{(peak - a0) / 2**20:.1f} MiB), their private pools reserve {pools}; "
                    f"p50 of {SERVING_SEQ} sequential "
                    f"{BERT_B}-row requests {np.median(ms):.3f} ms (min {min(ms):.3f}, max "
                    f"{max(ms):.3f}) [{self.card}]")
            finally:
                reg.shutdown()
        for tag in ("dequantized", "int8"):
            err = max(float(np.abs(a - f).max()) for a, f in zip(answers[tag], answers["f32"]))
            log(f"residency quantized: {tag} against f32 on {4 * BERT_B} rows: max |difference| "
                f"of probabilities {err:.4g} (a finding, not checked)")
        same = all(np.array_equal(a, b) for a, b in zip(answers["int8"], answers["dequantized"]))
        err = max(float(np.abs(a - b).max())
                  for a, b in zip(answers["int8"], answers["dequantized"]))
        log(f"residency quantized: int8-resident against dequantized-resident: "
            f"{'bit for bit' if same else 'NOT bit for bit'} (max |difference| {err:.3g}; bf16 "
            f"rounds the scale before the product in one, the dequantized weight in the other)")
        # the gate, before the hot-swap, through both serving paths
        golden = rng.integers(0, BERT_VOCAB, (RESIDENCY_GOLDEN, BERT_T))
        reg = ModelRegistry()
        try:
            reg.load("m0", m0, device=self.device, replay_manifest=False, save_manifest=False,
                     **kw)
            v1 = reg.get("m0")
            before = reg.predict("m0", probe[1])
            stop, errors, served_n = threading.Event(), [], [0]
            lock = threading.Lock()

            def client(c):
                crng = np.random.default_rng(c)
                while not stop.is_set():
                    x = crng.integers(0, BERT_VOCAB, (int(crng.integers(1, BERT_B + 1)), BERT_T))
                    try:
                        reg.predict("m0", x)
                        with lock:
                            served_n[0] += 1
                    except Exception as e:
                        with lock:
                            errors.append(e)

            ths = [threading.Thread(target=client, args=(c,), name=f"smoke-gate-{c}")
                   for c in range(4)]
            for t in ths:
                t.start()
            t0 = time.perf_counter()
            try:
                reg.deploy_quantized("m0", qpaths["dequantized"], golden,
                                     gate=AccuracyGate(max_delta=-1.0), device=self.device, **kw)
                refused = None
            except AccuracyGateFailed as e:
                refused = e
            gate_s = time.perf_counter() - t0
            stop.set()
            for t in ths:
                t.join(timeout=60)
            self.check(refused is not None and reg.get("m0") is v1 and v1.version == 1
                       and not errors and served_n[0] > 0
                       and np.array_equal(reg.predict("m0", probe[1]), before),
                       f"residency quantized: a gate of max_delta -1 refused the deploy in "
                       f"{gate_s:.1f} s ({getattr(refused, 'report', None)}); f32 v1 served "
                       f"{served_n[0]} requests of 4 clients meanwhile, errors={errors[:3]}, "
                       f"its answers unchanged")
            t0 = time.perf_counter()
            served = reg.deploy_quantized("m0", qpaths["dequantized"], golden,
                                          gate=AccuracyGate(max_delta=1.0), device=self.device,
                                          **kw)
            rep = served.gate_report
            self.check(served.version == 2 and rep["passed"] and rep["n_examples"] == len(golden),
                       f"residency quantized: a gate of max_delta 1 deployed v{served.version} in "
                       f"{time.perf_counter() - t0:.1f} s; top-1 agreement of random-init "
                       f"BERT-base on {rep['n_examples']} golden rows through the serving path: "
                       f"{rep['candidate_accuracy']} (delta {rep['accuracy_delta']})")
            log(f"residency quantized: gate report {rep} [{self.card}]")
        finally:
            reg.shutdown()
            gc.collect()

    def residency_rows(self):
        """int8 request rows on the char-RNNs (``TextGenerationLSTM(96, 512, 2
        layers)`` with GravesLSTM, LSTM and GRU cells, rows 1, 3, 5):
        calibrated on one-hot rows, 8 clients of f32 and int8 rows of 1-64 x
        T=256; each answer bit for bit the same dtype's at a bucket it may be
        served at; nothing captured on traffic; for GravesLSTM the 64-row p50
        and host share of int8 rows against f32 rows."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.models import ModelSerializer, MultiLayerNetwork
        from deeplearning4j_tpu_torch.serving import ModelRegistry
        from deeplearning4j_tpu_torch.serving.quantize import quantize_archive, quantize_requests
        eye = np.eye(VOCAB, dtype=np.float32)
        d = tempfile.mkdtemp(prefix=".chip_smoke-rows-", dir=ROOT)
        try:
            for cell in ("graves", "lstm", "gru"):
                tag = f"residency int8 rows {CHAR_RNN_TAGS[cell]}"
                kernel = self.cell_module(CHAR_RNN_KERNELS[cell])
                rng = np.random.default_rng(CHAR_RNN_SEEDS[cell] + 99)
                ids = lambda n: eye[rng.integers(0, VOCAB, (int(n), SERVE_T))]  # noqa: E731
                path, qpath = os.path.join(d, f"{cell}.zip"), os.path.join(d, f"{cell}.q.zip")
                net = MultiLayerNetwork(char_rnn_conf(cell, SERVE_T), device=self.device).init()
                ModelSerializer.write_model(net, path)
                del net
                policy, _ = quantize_archive(path, qpath, [ids(8) for _ in range(4)])
                reg = ModelRegistry()
                try:
                    served = reg.load("rows", qpath, device=self.device, max_batch_size=SERVE_B,
                                      batch_timeout_ms=5.0, warmup_example=ids(1),
                                      devices=[self.device], save_manifest=False)
                    b = served.batcher
                    graphs = b.compile_count()
                    self.check(graphs == 2 * len(b.buckets),
                               f"{tag}: {graphs} graphs after warm-up ({len(b.buckets)} buckets "
                               f"x f32 and int8)")
                    reqs = []
                    for c in range(CLIENTS):
                        r = []
                        for k in range(REQUESTS_PER_CLIENT):
                            x = ids(rng.integers(1, SERVE_B + 1))
                            r.append(quantize_requests(x, policy) if (c + k) % 2 else x)
                        reqs.append(r)
                    counters = all_counters()
                    batches0 = b.batches
                    quant0 = served.metrics.snapshot()["quantized_requests_total"]
                    # ---- the main path: counts from 0 just before, read just after
                    torch.cuda.synchronize()
                    for c in counters:
                        c.reset()
                    answers, lat, wall, errors = self.serve_clients(reg, "rows", reqs)
                    torch.cuda.synchronize()
                    counts = {c.name: c.value for c in counters}
                    # ----
                    batches = b.batches - batches0
                    want = {c.name: 0 for c in counters}
                    want[kernel.counter.name] = LAYERS * batches
                    self.check(not errors and counts == want,
                               f"{tag}: {len(lat)} requests answered (errors={errors[:3]}); "
                               f"{counts[kernel.counter.name]} {kernel.counter.name} launches "
                               f"= {LAYERS} x {batches} batches, nothing else")
                    self.add_launches({kernel.counter.name: counts[kernel.counter.name]})
                    n_int8 = sum(x.dtype == np.int8 for r in reqs for x in r)
                    self.check(b.compile_count() == graphs and
                               served.metrics.snapshot()["quantized_requests_total"] - quant0
                               == n_int8,
                               f"{tag}: {b.compile_count()} graphs after the mixed traffic "
                               f"(nothing captured on traffic); {n_int8} int8 requests counted")
                    bad = []
                    for c in range(CLIENTS):
                        for k, x in enumerate(reqs[c]):
                            n = x.shape[0]
                            cands = [self.at_bucket(b, x, bk) for bk in b.buckets if bk >= n]
                            if answers[c][k] is None or not any(
                                    np.array_equal(answers[c][k], r) for r in cands):
                                bad.append((c, k, str(x.dtype)))
                    self.check(not bad, f"{tag}: f32 and int8 rows coalesced apart, each answer "
                                        f"bit for bit its dtype's at a bucket it may be served "
                                        f"at (mismatches {bad[:4]})")
                    if cell == "graves":
                        xf = ids(SERVE_B)
                        xq = quantize_requests(xf, policy)
                        conc = [[ids(n) for n in rng.integers(1, SERVE_B + 1, SERVING_CONC[1])]
                                for _ in range(SERVING_CONC[0])]
                        f32 = self.serving_times(reg, "rows", xf, conc, f"{tag} f32 rows")
                        q8 = self.serving_times(reg, "rows", xq,
                                                [[quantize_requests(x, policy) for x in r]
                                                 for r in conc], f"{tag} int8 rows")
                        log(f"{tag}: {SERVE_B}-row p50 int8 {q8['p50_ms']:.3f} ms against f32 "
                            f"{f32['p50_ms']:.3f}; host {q8['host_ms']:.3f} against "
                            f"{f32['host_ms']:.3f} ms ({100 * q8['host_share']:.1f}% against "
                            f"{100 * f32['host_share']:.1f}%); rows in {xq.nbytes / 1e6:.2f} "
                            f"against {xf.nbytes / 1e6:.2f} MB [{self.card}]")
                        self.check(b.compile_count() == graphs,
                                   f"{tag}: {b.compile_count()} graphs after the timings")
                finally:
                    reg.shutdown()
        finally:
            shutil.rmtree(d, ignore_errors=True)

    def residency_plan(self, d):
        """Plan slices: parallel_pipe's dense net under compose(data=2,
        pipe=4, microbatches=2) over 8 x cuda:0 in fp32 (bit for bit
        ``net.output`` at the bucket, graphs = buckets x 2, nothing captured
        on traffic, the manifest replayed, refused flat and admitted sliced
        under a per-position budget of 0.6 of a copy); BERT-base under
        compose(data=2, tensor=2) over 4 x cuda:0 in bf16."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.models import ModelSerializer, MultiLayerNetwork
        from deeplearning4j_tpu_torch.nn import (DenseLayer, InputType, NeuralNetConfiguration,
                                                 OutputLayer)
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        from deeplearning4j_tpu_torch.parallel import ParallelPlan
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.serving import (ContinuousBatcher, HBMBudgetExceeded,
                                                      ModelRegistry)
        from deeplearning4j_tpu_torch.train import Sgd
        env = get_environment()
        env.set_compute_dtype("float32")
        try:
            b_ = NeuralNetConfiguration.builder().seed(7).updater(Sgd(0.05)).list()
            for _ in range(5):
                b_ = b_.layer(DenseLayer(n_out=64, activation="tanh"))
            conf = (b_.layer(OutputLayer(n_out=8, activation="softmax"))
                    .set_input_type(InputType.feed_forward(32)).build())
            net = MultiLayerNetwork(conf, device=self.device).init()
            devs = [self.device] * 8
            plan = ParallelPlan.compose(data=2, pipe=4, microbatches=2, devices_=devs)
            rng = np.random.default_rng(2525)
            reqs = [[rng.normal(0, 1, (int(n), 32)).astype(np.float32)
                     for n in rng.integers(1, 65, REQUESTS_PER_CLIENT)]
                    for _ in range(CLIENTS)]
            reg = ModelRegistry()
            try:
                for name, mb in (("pipe", 2), ("pipe-mb1", 1)):
                    served = reg.register(
                        name, net, plan=ParallelPlan.compose(
                            data=2, pipe=4, microbatches=mb, devices_=devs),
                        replicas=2, devices=devs, max_batch_size=64, batch_timeout_ms=5.0,
                        warmup_example=np.zeros((1, 32), np.float32))
                    b = served.batcher
                    pairs = len(b.buckets) * 2
                    self.check(b.compile_count() == pairs,
                               f"residency plan {name}: {b.compile_count()} graphs after "
                               f"warm-up ({len(b.buckets)} buckets x 2 plan slices)")
                    answers, lat, wall, errors = self.serve_clients(reg, name, reqs)
                    bad, worst = [], 0.0
                    for c in range(CLIENTS):
                        for k, x in enumerate(reqs[c]):
                            n = x.shape[0]
                            cands = []
                            for bk in (bk for bk in b.buckets if bk >= n):
                                padded = np.zeros((bk, 32), np.float32)
                                padded[:n] = x
                                cands.append(net.output(padded).float().cpu().numpy()[:n])
                            got = answers[c][k]
                            if got is None or not any(np.array_equal(got, r) for r in cands):
                                bad.append((c, k, n))
                            if got is not None:
                                worst = max(worst, min(float(np.abs(got - r).max())
                                                       for r in cands))
                    if mb == 1:
                        # every layer at the bucket's rows: net.output's products
                        self.check(not errors and not bad,
                                   f"residency plan {name} (microbatches 1): {CLIENTS} x "
                                   f"{REQUESTS_PER_CLIENT} answers bit for bit net.output at a "
                                   f"bucket they may be served at (mismatches {bad[:4]}, "
                                   f"closest max |difference| {worst:.3g}; errors {errors[:3]})")
                    else:
                        # the trunk runs on microbatches of half the rows, where
                        # cuBLAS may sum a row's products in another order
                        self.check(not errors and worst <= PIPE_MB_TOL,
                                   f"residency plan {name} (microbatches 2): {CLIENTS} x "
                                   f"{REQUESTS_PER_CLIENT} answers against net.output at the "
                                   f"bucket: {len(bad)} not bit for bit, closest max "
                                   f"|difference| {worst:.3g} <= {PIPE_MB_TOL:g}; errors "
                                   f"{errors[:3]}")
                        log(f"residency plan {name}: {CLIENTS * REQUESTS_PER_CLIENT - len(bad)} "
                            f"of {CLIENTS * REQUESTS_PER_CLIENT} answers bit for bit "
                            f"net.output at the bucket, the rest within {worst:.3g} (the "
                            f"trunk's microbatches of half the rows) [{self.card}]")
                    self.check(b.compile_count() == pairs and
                               set(served.metrics.snapshot()["replica_batches"]) == {0, 1},
                               f"residency plan {name}: {b.compile_count()} graphs after traffic "
                               f"(nothing captured on traffic), batches on both slices "
                               f"{served.metrics.snapshot()['replica_batches']}")
                served = reg.get("pipe")
                b = served.batcher
                m = b.warmup_manifest()
                b2 = ContinuousBatcher(net, max_batch_size=m.max_batch_size, batch_timeout_ms=5.0,
                                       replicas=m.replicas, buckets=list(m.buckets), plan=plan,
                                       devices=devs, warmup_example=m.example())
                try:
                    warm = b2.compile_count()
                    x = reqs[0][0]
                    again = b2.submit(x)
                    self.check(m.plan == plan.describe() and warm == len(m.pairs)
                               and b2.compile_count() == warm
                               and np.array_equal(again, reg.predict("pipe", x)),
                               f"residency plan pipe: the manifest records {m.plan}; a fresh "
                               f"batcher replayed its {len(m.pairs)} pairs ({warm} graphs, "
                               f"{b2.compile_count()} after a request answered as the first)")
                finally:
                    b2.shutdown()
            finally:
                reg.shutdown()
            copy = sum(t.numel() * t.element_size()
                       for layer in net.params().values() for t in layer.values())
            budget = int(0.6 * copy)
            reg = ModelRegistry(hbm_budget_bytes=budget)
            try:
                try:
                    reg.register("flat", net, devices=devs, max_batch_size=64,
                                 warmup_example=np.zeros((1, 32), np.float32))
                    flat = "admitted"
                except HBMBudgetExceeded:
                    flat = "refused"
                reg.register("sliced", net, plan=ParallelPlan.compose(
                    data=2, pipe=4, microbatches=1, devices_=devs), replicas=2, devices=devs,
                    max_batch_size=64, warmup_example=np.zeros((1, 32), np.float32))
                snap = reg.residency_snapshot()
                per = snap["per_device_bytes"]
                self.check(flat == "refused" and len(per) == 8 and max(per.values()) <= budget,
                           f"residency plan pipe: under a per-position budget of {budget} bytes "
                           f"(0.6 x one {copy}-byte copy) the flat model was {flat}, the "
                           f"plan-sliced one admitted: per position {per}; per card "
                           f"{snap['per_physical_device_bytes']}")
            finally:
                reg.shutdown()
        finally:
            env.allow_bfloat16()
        # BERT-base, tensor slices
        kw = self.residency_kw()
        model = ModelSerializer.restore_model(os.path.join(d, "m0.zip"), device=self.device,
                                              load_updater=False)
        devs = [self.device] * 4
        plan = ParallelPlan.compose(data=2, tensor=2, devices_=devs)
        reg = ModelRegistry()
        try:
            served = reg.register("bert-tp", model, plan=plan, replicas=2, devices=devs,
                                  max_batch_size=BERT_B, buckets=[1, BERT_B],
                                  batch_timeout_ms=5.0, warmup_example=kw["warmup_example"])
            b = served.batcher
            rng = np.random.default_rng(2626)
            probe = [rng.integers(0, BERT_VOCAB, (n, BERT_T)) for n in (1, BERT_B, 3, BERT_B)]
            counters = all_counters()
            batches0 = b.batches
            torch.cuda.synchronize()
            for c in counters:
                c.reset()
            got = [reg.predict("bert-tp", x) for x in probe]
            torch.cuda.synchronize()
            counts = {c.name: c.value for c in counters}
            batches = b.batches - batches0
            want = {c.name: 0 for c in counters}
            want[fa.counter.name] = BERT_LAYERS * 2 * batches
            self.check(counts == want and b.compile_count() == 4,
                       f"residency plan bert: {counts[fa.counter.name]} {fa.counter.name} over "
                       f"{batches} batches = {BERT_LAYERS} layers x 2 tensor pieces a batch "
                       f"(per replica, {BERT_LAYERS} per piece), nothing else; "
                       f"{b.compile_count()} graphs (2 buckets x 2 slices)")
            self.add_launches({fa.counter.name: counts[fa.counter.name]})
            worst = 0.0
            with plain_attention():
                for x, g in zip(probe, got):
                    n = x.shape[0]
                    bucket = next(bk for bk in b.buckets if bk >= n)
                    padded = np.zeros((bucket, BERT_T), x.dtype)
                    padded[:n] = x
                    ref = model.output(padded).float().cpu().numpy()[:n]
                    worst = max(worst, float(np.abs(g - ref).max()))
            self.check(worst <= BERT_TOL,
                       f"residency plan bert: answers vs the plain forward max_abs_err="
                       f"{worst:.3g} tol={BERT_TOL:g}")
            ms = []
            x_full = probe[1]
            reg.predict("bert-tp", x_full)
            for _ in range(SERVING_SEQ):
                t0 = time.perf_counter()
                reg.predict("bert-tp", x_full)
                ms.append(1e3 * (time.perf_counter() - t0))
            snap = reg.residency_snapshot()
            log(f"residency plan bert: compose(data=2, tensor=2) over 4 x {self.device}: "
                f"{BERT_B}-row p50 {np.median(ms):.3f} ms (min {min(ms):.3f}, max "
                f"{max(ms):.3f}); per position "
                f"{ {k: round(v / 2**20, 1) for k, v in snap['per_device_bytes'].items()} } "
                f"MiB [{self.card}]")
        finally:
            reg.shutdown()
            del model

    def residency_inference(self, d):
        """``ParallelInference.builder(bert).workers(2)`` on one card clamps
        to one worker; its 64-row answers bit for bit the registry's for the
        same archive."""
        import numpy as np
        from deeplearning4j_tpu_torch.models import ModelSerializer
        from deeplearning4j_tpu_torch.parallel import ParallelInference
        from deeplearning4j_tpu_torch.serving import ModelRegistry
        path = os.path.join(d, "m0.zip")
        kw = self.residency_kw()
        model = ModelSerializer.restore_model(path, device=self.device, load_updater=False)
        pi = ParallelInference.builder(model).workers(2).max_batch_size(BERT_B).build()
        reg = ModelRegistry()
        try:
            reg.load("m0", path, device=self.device, replay_manifest=False, save_manifest=False,
                     **kw)
            rng = np.random.default_rng(2727)
            xs = [rng.integers(0, BERT_VOCAB, (BERT_B, BERT_T)) for _ in range(3)]
            same = all(np.array_equal(pi.output(x), reg.predict("m0", x)) for x in xs)
            self.check(pi.workers == 1 and same,
                       f"residency parallel inference: workers(2) on one card gave "
                       f"{pi.workers} worker; {len(xs)} {BERT_B}-row answers bit for bit the "
                       f"registry's for the same archive: {same}")
        finally:
            pi.shutdown()
            reg.shutdown()

    # ----------------------------------------------------------------- http
    def http_phase(self, workdir):
        """Serving's host side at full width, each part a phase of its own:
        the BERT-base worker, the GravesLSTM char-RNN worker, sessions over
        HTTP, the router over two BERT-base workers, gated deploys."""
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        env = get_environment()
        env.allow_bfloat16()
        st = {"servers": []}
        try:
            for name, part in (("bert", lambda: self.http_bert(workdir, st)),
                               ("graves", lambda: self.http_graves(workdir, st)),
                               ("sessions", lambda: self.http_sessions(workdir)),
                               ("router", lambda: self.http_router(st)),
                               ("deploy", lambda: self.http_deploy(workdir))):
                self.phase(f"http {name}", part)
        finally:
            for srv in st["servers"]:
                srv.stop(shutdown_registry=True)
            env.allow_bfloat16()

    def bert_archive(self, workdir):
        """``Bert.base()``'s archive in ``workdir``, written once for the
        phases that serve it."""
        from deeplearning4j_tpu_torch.models import ModelSerializer
        from deeplearning4j_tpu_torch.zoo import Bert
        path = os.path.join(workdir, "bert-base.zip")
        if not os.path.exists(path):
            net = Bert.base().init(device=self.device)
            ModelSerializer.write_model(net, path)
            del net
        return path

    def graves_archive(self, workdir):
        """The GravesLSTM char-RNN's archive in ``workdir`` (the serving
        phase's where it wrote one)."""
        from deeplearning4j_tpu_torch.models import ModelSerializer, MultiLayerNetwork
        path = os.path.join(workdir, "serving-graves.zip")
        if not os.path.exists(path):
            net = MultiLayerNetwork(char_rnn_conf("graves", SERVE_T), device=self.device).init()
            ModelSerializer.write_model(net, path)
            del net
        return path

    def http_bert_kw(self, example):
        """BERT-base's worker: 64-row requests, 2 replicas on the card, 2
        batches in flight, warmed on ``example`` before traffic."""
        return dict(max_batch_size=BERT_B, buckets=[BERT_B], batch_timeout_ms=5.0,
                    warmup_example=example, devices=[self.device] * SERVING_REPLICAS,
                    replicas=SERVING_REPLICAS, pipeline_depth=SERVING_DEPTH)

    def http_traffic(self, counters, batcher, requests):
        """Run ``requests()`` with every launch counter at 0 just before and
        read just after: ``(its result, counts, batches, replays)``."""
        torch = self.torch
        batches0, replays0 = batcher.batches, aot_replays()
        torch.cuda.synchronize()
        for c in counters:
            c.reset()
        out = requests()
        torch.cuda.synchronize()
        counts = {c.name: c.value for c in counters}
        return out, counts, batcher.batches - batches0, aot_replays() - replays0

    def check_launches(self, tag, counts, counter, per_batch, batches):
        want = {name: 0 for name in counts}
        want[counter.name] = per_batch * batches
        self.check(counts == want, f"{tag}: {counts[counter.name]} {counter.name} launches over "
                                   f"the traffic (expected {per_batch} x {batches} batches), "
                                   f"nothing else: {counts}")
        self.add_launches({counter.name: counts[counter.name]})

    def http_bert(self, workdir, st):
        """BERT-base behind a ``ModelServer``: 64-row requests over JSON and
        the binary wire, bit for bit ``registry.predict``, through replays
        only, 12 flash launches a batch; p50s, bytes and the JSON's host
        cost."""
        import numpy as np
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        from deeplearning4j_tpu_torch.serving import ModelRegistry, ModelServer, wire
        tag = "http bert"
        path = self.bert_archive(workdir)
        rng = np.random.default_rng(2424)
        example = rng.integers(0, BERT_VOCAB, (1, BERT_T))
        reg = ModelRegistry()
        srv = ModelServer(reg, worker_id="bert-a")
        st["servers"].append(srv)
        t0 = time.perf_counter()
        served = reg.load("bert", path, device=self.device, replay_manifest=False,
                          save_manifest=False, **self.http_bert_kw(example))
        address = f"127.0.0.1:{srv.start(0)}"
        st["bert"] = (srv, reg, example)
        b = served.batcher
        graphs = b.compile_count()
        log(f"{tag}: load + warm-up {time.perf_counter() - t0:.1f} s, {graphs} graphs, serving "
            f"on {address}")
        self.check(graphs == SERVING_REPLICAS, f"{tag}: {graphs} graphs after warm-up (expected "
                                               f"1 bucket x {SERVING_REPLICAS} replicas)")
        xs = [rng.integers(0, BERT_VOCAB, (BERT_B, BERT_T)) for _ in range(3)]
        want = [reg.predict("bert", x) for x in xs]
        pool = wire.ConnectionPool()
        try:
            got, counts, batches, replays = self.http_traffic(
                all_counters(), b,
                lambda: [(http_json(pool, address, "bert", x), http_wire(pool, address, "bert", x))
                         for x in xs])
            statuses = [(j[0], w[0]) for j, w in got]
            self.check(statuses == [(200, 200)] * len(xs),
                       f"{tag}: {2 * len(xs)} requests answered 200: {statuses}")
            for proto, k in (("JSON (parsed back to float32)", 0), ("binary", 1)):
                same = all(g[k][1] is not None and arrays_equal(g[k][1], w)
                           for g, w in zip(got, want))
                self.check(same, f"{tag}: {len(xs)} {BERT_B}-row answers over {proto} bit for "
                                 f"bit registry.predict of the same rows")
            h = got[0][1][2]
            self.check((h.get("X-Worker-Id"), h.get("X-Model-Version")) == ("bert-a", "1"),
                       f"{tag}: X-Worker-Id / X-Model-Version {h.get('X-Worker-Id')} / "
                       f"{h.get('X-Model-Version')}")
            self.check(batches == 2 * len(xs) and replays == batches,
                       f"{tag}: {replays} graph replays over {batches} batches (one a request, "
                       f"no batch ran eagerly)")
            self.check_launches(tag, counts, fa.counter, BERT_LAYERS, batches)
            self.check(b.compile_count() == graphs,
                       f"{tag}: {b.compile_count()} graphs after traffic (nothing captured)")
            log(f"{tag}: JSON ids parse as int64 (declared \"dtype\": \"int64\"), the warm-up "
                f"example's dtype ({example.dtype}): they replay the warmed (bucket, replica, "
                f"dtype) graphs {b._warmed_pairs}")
            expect = {"flash_fwd_mma_kernel": BERT_LAYERS}
            ran = self.recurrent_kernels(lambda: http_json(pool, address, "bert", xs[0]), expect,
                                         pattern=FLASH_FWD_KERNEL)
            self.check(ran == expect, f"{tag}: one JSON request ran {ran} by the profiler's names "
                                      f"(expected {expect})")
            per, _ = self.profile_kernels(lambda: reg.predict("bert", xs[0]), 5)
            busy = sum(ms for ms, _ in per.values())
            x = xs[0]
            times = {"in-process": p50_ms(lambda: reg.predict("bert", x), HTTP_SEQ),
                     "JSON": p50_ms(lambda: http_json(pool, address, "bert", x), HTTP_SEQ),
                     "binary": p50_ms(lambda: http_wire(pool, address, "bert", x), HTTP_SEQ)}
            sizes = {"JSON": got[0][0][3:5], "binary": got[0][1][3:5]}
            self.http_split("bert", x, want[0], busy)
            log(f"{tag}: p50 of {HTTP_SEQ} sequential {BERT_B}-row requests: "
                + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
                + f"; device busy {busy:.3f} ms a request (torch.profiler); bytes sent / "
                  f"received a request: JSON {sizes['JSON'][0]} / {sizes['JSON'][1]}, binary "
                  f"{sizes['binary'][0]} / {sizes['binary'][1]} [{self.card}]")
        finally:
            pool.close()

    def http_split(self, what, x, out, busy_ms):
        """The host cost of one JSON request's four conversions, each timed on
        this host on the same arrays: the client printing the body, the
        server parsing it, the server printing the answer, the client
        parsing it; beside the device busy time of one request."""
        import numpy as np
        t = {}
        t0 = time.perf_counter()
        body = json.dumps({"inputs": x.tolist(), "dtype": str(x.dtype)})
        t["print request"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        parsed = json.loads(body)
        np.asarray(parsed["inputs"], dtype=np.dtype(parsed["dtype"]))
        t["parse request"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        answer = json.dumps({"model": what, "version": 1, "outputs": np.asarray(out).tolist()})
        t["print answer"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        np.asarray(json.loads(answer)["outputs"], np.float32)
        t["parse answer"] = time.perf_counter() - t0
        log(f"http {what} JSON host cost (this host, the same arrays): "
            + ", ".join(f"{k} {1e3 * v:.3f} ms" for k, v in t.items())
            + f"; {len(body)} / {len(answer)} bytes; device busy {busy_ms:.3f} ms a request "
              f"[{self.card}]")

    def http_graves(self, workdir, st):
        """The GravesLSTM char-RNN at T=256 behind a ``ModelServer``:
        full-bucket requests over the binary wire bit for bit
        ``registry.predict``, 2 launches a batch through replays; p50s; one
        JSON request timed."""
        import numpy as np
        from deeplearning4j_tpu_torch.ops.kernels import fused_lstm_graves
        from deeplearning4j_tpu_torch.serving import ModelRegistry, ModelServer, wire
        tag = "http graves=True"
        path = self.graves_archive(workdir)
        eye = np.eye(VOCAB, dtype=np.float32)
        rng = np.random.default_rng(2525)
        ids = lambda n: eye[rng.integers(0, VOCAB, (int(n), SERVE_T))]  # noqa: E731
        reg = ModelRegistry()
        srv = ModelServer(reg, worker_id="graves")
        st["servers"].append(srv)
        t0 = time.perf_counter()
        served = reg.load("char-rnn", path, device=self.device, max_batch_size=SERVE_B,
                          buckets=[SERVE_B], batch_timeout_ms=5.0, warmup_example=ids(1),
                          devices=[self.device] * SERVING_REPLICAS, replicas=SERVING_REPLICAS,
                          pipeline_depth=SERVING_DEPTH, replay_manifest=False,
                          save_manifest=False)
        address = f"127.0.0.1:{srv.start(0)}"
        b = served.batcher
        graphs = b.compile_count()
        log(f"{tag}: load + warm-up {time.perf_counter() - t0:.1f} s, {graphs} graphs")
        xs = [ids(SERVE_B) for _ in range(3)]
        want = [reg.predict("char-rnn", x) for x in xs]
        pool = wire.ConnectionPool()
        try:
            got, counts, batches, replays = self.http_traffic(
                all_counters(), b, lambda: [http_wire(pool, address, "char-rnn", x) for x in xs])
            same = all(g[0] == 200 and g[1] is not None and arrays_equal(g[1], w)
                       for g, w in zip(got, want))
            self.check(same, f"{tag}: {len(xs)} full-bucket ({SERVE_B} x {SERVE_T} x {VOCAB}) "
                             f"requests over the binary wire bit for bit registry.predict "
                             f"(statuses {[g[0] for g in got]})")
            self.check(batches == len(xs) and replays == batches,
                       f"{tag}: {replays} graph replays over {batches} batches")
            self.check_launches(tag, counts, fused_lstm_graves.counter, LAYERS, batches)
            self.check(b.compile_count() == graphs,
                       f"{tag}: {b.compile_count()} graphs after traffic (nothing captured)")
            x = xs[0]
            times = {"in-process": p50_ms(lambda: reg.predict("char-rnn", x), HTTP_SEQ),
                     "binary": p50_ms(lambda: http_wire(pool, address, "char-rnn", x), HTTP_SEQ)}
            t0 = time.perf_counter()
            status, out, _, sent, received = http_json(pool, address, "char-rnn", x)
            json_ms = 1e3 * (time.perf_counter() - t0)
            self.check(status == 200 and out is not None and arrays_equal(out, want[0]),
                       f"{tag}: one full-bucket JSON request (parsed back to float32) bit for "
                       f"bit registry.predict (status {status})")
            per, _ = self.profile_kernels(lambda: reg.predict("char-rnn", x), 5)
            self.http_split("char-rnn", x, want[0], sum(ms for ms, _ in per.values()))
            log(f"{tag}: p50 of {HTTP_SEQ} sequential full-bucket requests: "
                + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
                + f"; one JSON request {json_ms:.1f} ms, {sent} bytes sent / {received} received; "
                  f"binary {got[0][3]} / {got[0][4]} [{self.card}]")
        finally:
            pool.close()

    def http_sessions(self, workdir):
        """Sessions over HTTP on the LSTM char-RNN (2 replicas on cuda:0):
        open, ``step`` with step indices, a replay of the last step, a
        ``step_conflict``, then the rest as Server-Sent Events over one
        connection; every step bit for bit a serial ``rnn_time_step`` loop
        padded to SESSION_BUCKET, 2 launches a step batch through replays."""
        import urllib.request
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.models import MultiLayerNetwork
        from deeplearning4j_tpu_torch.ops.kernels import fused_lstm
        from deeplearning4j_tpu_torch.serving import ModelRegistry, ModelServer
        tag = "http sessions"
        net = MultiLayerNetwork(char_rnn_conf("lstm", SERVE_T), device=self.device).init()
        eye = np.eye(VOCAB, dtype=np.float32)
        rng = np.random.default_rng(3232)
        chunks = [eye[rng.integers(0, VOCAB, (1, SESSION_T))] for _ in range(SESSION_STEPS)]
        half = SESSION_STEPS // 2
        reg = ModelRegistry()
        srv = ModelServer(reg, worker_id="sessions",
                          session_dir=os.path.join(workdir, "http-sessions"),
                          session_kw={"start_evictor": False})
        try:
            served = reg.register("lstm", net, max_batch_size=SERVE_B,
                                  devices=[self.device] * SERVING_REPLICAS,
                                  replicas=SERVING_REPLICAS, pipeline_depth=SERVING_DEPTH,
                                  batch_timeout_ms=5.0)
            b = served.batcher
            b.enable_sessions(np.zeros((1, SESSION_T, VOCAB), np.float32),
                              session_bucket=SESSION_BUCKET)
            graphs = b.compile_count()
            address = f"127.0.0.1:{srv.start(0)}"
            base = "/v1/models/lstm/sessions"
            steps, lat = [], []

            def stream():
                status, _, data = http_post(address, base, {})
                sid = json.loads(data)["session"] if status == 200 else None
                for i in range(half):
                    t0 = time.perf_counter()
                    status, h, data = http_post(address, f"{base}/{sid}/step",
                                                {"inputs": chunks[i].tolist(),
                                                 "dtype": "float32", "step": i})
                    lat.append(time.perf_counter() - t0)
                    steps.append((status, h.get("X-Session-Step"), json.loads(data)))
                replay = http_post(address, f"{base}/{sid}/step",
                                   {"inputs": chunks[half - 1].tolist(), "dtype": "float32",
                                    "step": half - 1})
                conflict = http_post(address, f"{base}/{sid}/step",
                                     {"inputs": chunks[half].tolist(), "dtype": "float32",
                                      "step": half + 5})
                t0 = time.perf_counter()
                sse = http_post(address, f"{base}/{sid}/stream",
                                {"inputs": [c.tolist() for c in chunks[half:]],
                                 "dtype": "float32", "step": half})
                sse_s = time.perf_counter() - t0
                req = urllib.request.Request(f"http://{address}{base}/{sid}", method="DELETE")
                with urllib.request.urlopen(req, timeout=60) as resp:
                    closed = resp.status
                return sid, replay, conflict, sse, sse_s, closed

            b0 = b.metrics.snapshot()["batches_total"]
            replays0 = aot_replays()
            counters = all_counters()
            torch.cuda.synchronize()
            for c in counters:
                c.reset()
            sid, replay, conflict, sse, sse_s, closed = stream()
            torch.cuda.synchronize()
            counts = {c.name: c.value for c in counters}
            step_batches = b.metrics.snapshot()["batches_total"] - b0
            replays = aot_replays() - replays0
            frames = [f for f in sse[2].decode().split("\n\n") if f.strip()]
            events = [json.loads(f[len("data:"):]) for f in frames if f.startswith("data:")]
            ends = [f for f in frames if f.startswith("event: end")]
            outs = [np.asarray(o["outputs"], np.float32) for _, _, o in steps] + \
                [np.asarray(e["outputs"], np.float32) for e in events]
            self.check(sid is not None and [s[:2] for s in steps] ==
                       [(200, str(i + 1)) for i in range(half)],
                       f"{tag}: session {sid} opened, {half} steps answered with X-Session-Step "
                       f"1..{half}: {[s[:2] for s in steps]}")
            robj = json.loads(replay[2])
            self.check(replay[0] == 200 and robj.get("replayed") is True
                       and robj.get("step") == half
                       and arrays_equal(np.asarray(robj["outputs"], np.float32), outs[half - 1]),
                       f"{tag}: a replay of step {half - 1} answered its persisted output "
                       f"(replayed {robj.get('replayed')}, step {robj.get('step')})")
            self.check(conflict[0] == 409
                       and json.loads(conflict[2]).get("reason") == "step_conflict",
                       f"{tag}: a step at the wrong position got {conflict[0]} "
                       f"{json.loads(conflict[2]).get('reason')}")
            self.check(sse[0] == 200 and sse[1].get("Content-Type", "").startswith(
                "text/event-stream") and [e["step"] for e in events] ==
                list(range(half + 1, SESSION_STEPS + 1)) and len(ends) == 1,
                f"{tag}: the stream of {SESSION_STEPS - half} steps over one connection gave "
                f"events at steps {[e['step'] for e in events]} and {len(ends)} end event")
            self.check(closed == 200, f"{tag}: DELETE closed the session ({closed})")
            self.check(step_batches == SESSION_STEPS and replays == step_batches,
                       f"{tag}: {step_batches} step batches for {SESSION_STEPS} steps (the replay "
                       f"ran nothing), {replays} graph replays")
            self.check_launches(tag, counts, fused_lstm.counter, LAYERS, step_batches)
            self.check(b.compile_count() == graphs,
                       f"{tag}: {b.compile_count()} graphs after the stream (nothing captured)")
            net.rnn_clear_previous_state()
            exact = len(outs) == SESSION_STEPS
            for i, c in enumerate(chunks):
                xb = np.zeros((SESSION_BUCKET, SESSION_T, VOCAB), np.float32)
                xb[0] = c[0]
                ref = net.rnn_time_step(xb).float().cpu().numpy()[:1]
                exact = exact and i < len(outs) and arrays_equal(outs[i], ref)
            net.rnn_clear_previous_state()
            self.check(exact, f"{tag}: {half} unary steps and {SESSION_STEPS - half} streamed "
                              f"steps bit for bit a serial rnn_time_step loop padded to "
                              f"{SESSION_BUCKET} rows (the replay advanced no carry)")
            ms = sorted(1e3 * v for v in lat)
            log(f"{tag}: unary step p50 {ms[len(ms) // 2]:.3f} ms over HTTP ({SESSION_T} tokens); "
                f"{SESSION_STEPS - half} streamed steps in {1e3 * sse_s:.1f} ms [{self.card}]")
        finally:
            srv.stop(shutdown_registry=True)

    def http_router(self, st):
        """A ``FleetRouter`` over two in-process BERT-base workers (the
        ``http bert`` worker and a second registry on cuda:0): routed answers
        bit for bit the in-process answer whichever worker served; a
        straggler hedged; one worker stopped under HTTP_CLIENTS clients and
        restarted, ``memory_allocated`` back where it was."""
        import gc
        import numpy as np
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        from deeplearning4j_tpu_torch.runtime import chaos
        from deeplearning4j_tpu_torch.serving import FleetRouter, ModelRegistry, ModelServer, wire
        tag = "http router"
        srv_a, reg_a, example = st["bert"]
        st["servers"].remove(srv_a)  # the fleet stops it now
        model = reg_a.get("bert").model

        def launch(wid, archive, version):
            # a registry of its own over the restored model: its own
            # parameter copies, streams and graphs
            reg = ModelRegistry()
            srv = ModelServer(reg, worker_id=wid)
            reg.register("bert", model, version=version, **self.http_bert_kw(example))
            srv.start(0)
            return srv

        fleet = InProcFleet(launch)
        fleet.add("bert-a", "bert-base.zip", server=srv_a)
        t0 = time.perf_counter()
        fleet.add("bert-b", "bert-base.zip")
        log(f"{tag}: second worker up in {time.perf_counter() - t0:.1f} s")
        router = FleetRouter(fleet, probe_interval_s=0.05, hedge_initial_ms=HTTP_HEDGE_MS,
                             hedge_min_ms=HTTP_HEDGE_MS)
        pool = wire.ConnectionPool()
        try:
            address = f"127.0.0.1:{router.start(0)}"
            self.check(wait_for(lambda: sum(v.ready for v in router.workers().values()) == 2),
                       f"{tag}: both workers ready behind the router")
            rng = np.random.default_rng(2626)
            xs = [rng.integers(0, BERT_VOCAB, (BERT_B, BERT_T)) for _ in range(4)]
            want = [reg_a.predict("bert", x) for x in xs]

            def exact(k, got):
                return got is not None and arrays_equal(got, want[k % len(xs)])

            # ---- routed answers, JSON and binary
            got, counts, batches, _ = self.http_traffic(
                all_counters(), reg_a.get("bert").batcher,
                lambda: [(http_json(pool, address, "bert", x), http_wire(pool, address, "bert", x))
                         for x in xs])
            ok = all(j[0] == w[0] == 200 and exact(k, j[1]) and exact(k, w[1])
                     for k, (j, w) in enumerate(got))
            by = sorted({g[2].get("X-Worker-Id") for pair in got for g in pair})
            self.check(ok, f"{tag}: {2 * len(xs)} routed requests (JSON, binary) bit for bit the "
                           f"in-process answer (served by {by})")
            self.add_launches({fa.counter.name: counts[fa.counter.name]})
            self.check(counts[fa.counter.name] % BERT_LAYERS == 0
                       and counts[fa.counter.name] >= BERT_LAYERS * 2 * len(xs),
                       f"{tag}: {counts[fa.counter.name]} flash launches for {2 * len(xs)} "
                       f"routed requests (12 a batch)")

            # ---- a straggler hedged: the first attempt of each request held
            class Straggle(chaos.Policy):
                def apply(self, point, index, rng_, controller):
                    if index % 2 == 1:
                        time.sleep(HTTP_STRAGGLE_S)
                        return f"latency:{HTTP_STRAGGLE_S}"
                    return None

            before = router.metrics.snapshot()
            with chaos.ChaosController(seed=24) as c:
                c.on("serving.worker.predict", Straggle())
                hedged = [http_wire(pool, address, "bert", x) for x in xs[:HTTP_HEDGED]]
            wait_for(lambda: router.metrics.snapshot()["hedges_discarded_total"]
                     - before["hedges_discarded_total"] >= HTTP_HEDGED, 10.0)
            after = router.metrics.snapshot()
            delta = {k: after[k] - before[k] for k in ("hedges_total", "hedge_wins_total",
                                                       "hedges_discarded_total", "responses_total")}
            self.check(all(g[0] == 200 and exact(k, g[1]) for k, g in enumerate(hedged))
                       and delta == {k: HTTP_HEDGED for k in delta},
                       f"{tag}: {HTTP_HEDGED} requests whose first attempt straggled "
                       f"{HTTP_STRAGGLE_S} s (chaos at serving.worker.predict): one response "
                       f"each, bit for bit, served by {[g[2].get('X-Worker-Id') for g in hedged]};"
                       f" {delta}")

            # ---- one worker stopped under load, restarted, readmitted
            gc.collect()
            before_bytes = self.allocated()

            def ask(c, k):
                status, out, _, _, _ = http_wire(pools[c], address, "bert", xs[(c + k) % len(xs)])
                return status, exact(c + k, out)

            pools = [wire.ConnectionPool() for _ in range(HTTP_CLIENTS)]
            try:
                with Clients(HTTP_CLIENTS, ask) as load:
                    time.sleep(0.5)
                    t0 = time.perf_counter()
                    fleet.stop_worker("bert-b")
                    stop_s = time.perf_counter() - t0
                    time.sleep(1.0)
            finally:
                for p in pools:
                    p.close()
            bad = [o for o in load.outcomes if o[2] != 200 or o[3] is not True]
            self.check(load.outcomes and not bad,
                       f"{tag}: {len(load.outcomes)} requests from {HTTP_CLIENTS} clients while "
                       f"bert-b stopped ({stop_s:.2f} s to stop): {len(bad)} failed or not bit "
                       f"for bit {bad[:3]}")
            t0 = time.perf_counter()
            fleet.add("bert-b", "bert-base.zip")
            router.readmit("bert-b")
            ready_s = router.await_ready("bert-b", timeout_s=120.0)
            router.drain("bert-a", timeout_s=30.0)
            after_b = [http_wire(pool, address, "bert", x) for x in xs]
            router.readmit("bert-a")
            self.check(all(g[0] == 200 and exact(k, g[1]) and g[2].get("X-Worker-Id") == "bert-b"
                           for k, g in enumerate(after_b)),
                       f"{tag}: bert-b rebuilt and readmitted in {time.perf_counter() - t0:.1f} s "
                       f"(ready after {ready_s:.2f} s); with bert-a drained its {len(xs)} answers "
                       f"bit for bit")
            gc.collect()
            after_bytes = self.allocated()
            self.check(abs(after_bytes - before_bytes) <= HTTP_MEM_SLACK,
                       f"{tag}: memory_allocated {before_bytes / 2**20:.2f} MiB before the stop, "
                       f"{after_bytes / 2**20:.2f} MiB after the restart and readmission "
                       f"({(after_bytes - before_bytes) / 2**20:+.2f} MiB; limit "
                       f"{HTTP_MEM_SLACK / 2**20:.0f} MiB)")
            x = xs[0]
            times = {"router JSON": p50_ms(lambda: http_json(pool, address, "bert", x), HTTP_SEQ),
                     "router binary": p50_ms(lambda: http_wire(pool, address, "bert", x),
                                             HTTP_SEQ)}
            log(f"{tag}: p50 of {HTTP_SEQ} sequential {BERT_B}-row requests through the router: "
                + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()) + f" [{self.card}]")
        finally:
            pool.close()
            router.stop()
            fleet.stop()

    def http_deploy(self, workdir):
        """Gated deploys of the GravesLSTM char-RNN through the router over
        an in-process fleet of two one-replica workers under client traffic:
        an equal candidate promotes (gate, shadow, ramped canary, the fleet
        rolled); a perturbed head fails a strict gate and, behind a lax one,
        is caught in shadow and rolled back."""
        import numpy as np
        torch = self.torch
        from deeplearning4j_tpu_torch.models import ModelSerializer
        from deeplearning4j_tpu_torch.ops.kernels import fused_lstm_graves
        from deeplearning4j_tpu_torch.runtime import journal
        from deeplearning4j_tpu_torch.runtime.trees import tree_map
        from deeplearning4j_tpu_torch.serving import FleetRouter, ModelRegistry, ModelServer, wire
        from deeplearning4j_tpu_torch.serving.delivery import DeliveryConfig, GateFailed, GoldenSet
        from deeplearning4j_tpu_torch.serving.slo import SLOTarget
        tag = "http deploy"
        d = os.path.join(workdir, "http-deploy")
        os.makedirs(d, exist_ok=True)
        src = self.graves_archive(workdir)
        a1, a2, abad = (os.path.join(d, f"{v}.zip") for v in ("v1", "v2", "bad"))
        shutil.copyfile(src, a1)
        shutil.copyfile(src, a2)
        net = ModelSerializer.restore_model(a1, device=self.device, load_updater=False)
        params = dict(net.params())
        head = list(params)[-1]  # the output layer: every class rolled by one
        params[head] = tree_map(lambda t: torch.roll(t, 1, -1), params[head])
        net.set_params(params)
        ModelSerializer.write_model(net, abad)
        del net, params
        eye = np.eye(VOCAB, dtype=np.float32)
        rng = np.random.default_rng(2828)
        ids = lambda n: eye[rng.integers(0, VOCAB, (int(n), SERVE_T))]  # noqa: E731
        golden = ids(HTTP_GOLDEN)
        GoldenSet(golden).save(GoldenSet.sidecar(a2))
        GoldenSet(golden, max_delta=1.0).save(GoldenSet.sidecar(abad))
        kw = dict(max_batch_size=HTTP_DEPLOY_BUCKET, buckets=[HTTP_DEPLOY_BUCKET],
                  batch_timeout_ms=2.0, warmup_example=ids(1), replicas=1, devices=[self.device],
                  replay_manifest=False, save_manifest=False)

        def launch(wid, archive, version):
            reg = ModelRegistry()
            srv = ModelServer(reg, worker_id=wid)
            try:
                reg.load("char-rnn", archive, device=self.device, version=version, **kw)
                srv.start(0)
            except Exception:
                srv.stop(shutdown_registry=True)
                raise
            return srv

        fleet = InProcFleet(launch)
        router = None
        try:
            t0 = time.perf_counter()
            fleet.add("w0", a1)
            fleet.add("w1", a1)
            log(f"{tag}: two workers up in {time.perf_counter() - t0:.1f} s")
            router = FleetRouter(fleet, probe_interval_s=0.05, hedge_enabled=False)
            address = f"127.0.0.1:{router.start(0)}"
            self.check(wait_for(lambda: sum(v.ready for v in router.workers().values()) == 2),
                       f"{tag}: both workers ready")
            probes = [ids(1) for _ in range(4)]
            pool = wire.ConnectionPool()
            try:
                w0 = fleet.endpoints()["w0"]
                ref = [http_wire(pool, w0, "char-rnn", x)[1] for x in probes]
            finally:
                pool.close()
            pools = [wire.ConnectionPool() for _ in range(HTTP_DEPLOY_CLIENTS)]

            def ask(c, k):
                status, out, _, _, _ = http_wire(pools[c], address, "char-rnn",
                                                 probes[(c + k) % len(probes)])
                return status, out is not None and arrays_equal(out, ref[(c + k) % len(probes)])

            cfg = DeliveryConfig(shadow_fraction=1.0, shadow_min_samples=4,
                                 canary_fractions=(0.5, 1.0), canary_min_requests=6,
                                 canary_target=SLOTarget(availability=0.5, latency_ms=5000.0,
                                                         latency_target=0.5),
                                 canary_window_s=30, stage_timeout_s=60.0)
            j = journal.enable(capacity=16384)
            counters = all_counters()
            refused, times = None, {}
            torch.cuda.synchronize()
            for c in counters:
                c.reset()
            try:
                with Clients(HTTP_DEPLOY_CLIENTS, ask) as load:
                    time.sleep(0.2)
                    t0 = time.perf_counter()
                    good = router.rolling_deploy(a2, version=2, strategy="gated",
                                                 model="char-rnn", delivery_config=cfg,
                                                 ready_timeout_s=120)
                    times["promote"] = time.perf_counter() - t0
                    restarts = len(fleet.restarts)
                    t0 = time.perf_counter()
                    try:
                        router.rolling_deploy(abad, version=3, strategy="gated",
                                              model="char-rnn", delivery_config=cfg,
                                              golden_set=GoldenSet(golden, max_delta=0.0))
                    except GateFailed as e:
                        refused = e.report
                    times["strict gate"] = time.perf_counter() - t0
                    strict_restarts = len(fleet.restarts) - restarts
                    t0 = time.perf_counter()
                    bad = router.rolling_deploy(abad, version=3, strategy="gated",
                                                model="char-rnn", delivery_config=cfg,
                                                ready_timeout_s=120)
                    times["rollback"] = time.perf_counter() - t0
                    time.sleep(0.2)
            finally:
                for p in pools:
                    p.close()
            torch.cuda.synchronize()
            counts = {c.name: c.value for c in counters}
            self.add_launches({fused_lstm_graves.counter.name:
                               counts[fused_lstm_graves.counter.name]})
            self.check(good.get("verdict") == "promoted"
                       and good["delivery"]["client_errors"] == 0
                       and [fleet.worker_archive(w) for w in ("w0", "w1")] == [a2, a2],
                       f"{tag}: the equal candidate {good.get('verdict')} in "
                       f"{times['promote']:.1f} s, the fleet on v2, client errors "
                       f"{good.get('delivery', {}).get('client_errors')}")
            # bf16 probabilities of a random head tie often, so a rolled head
            # keeps the top-1 of some tied rows: most, not all, disagree
            self.check(refused is not None and refused.get("accuracy_delta", 0.0) > 0.5
                       and strict_restarts == 0,
                       f"{tag}: the perturbed head refused by a strict gate in "
                       f"{times['strict gate']:.1f} s before any worker was touched "
                       f"(accuracy_delta {None if refused is None else refused.get('accuracy_delta')}, "
                       f"{strict_restarts} restarts)")
            self.check(bad.get("verdict") == "rolled_back"
                       and bad.get("cause") == "shadow_divergence"
                       and bad["delivery"]["client_errors"] == 0
                       and [fleet.worker_archive(w) for w in ("w0", "w1")] == [a2, a2],
                       f"{tag}: behind its lax gate the perturbed head was "
                       f"{bad.get('verdict')} ({bad.get('cause')}) in {times['rollback']:.1f} s, "
                       f"the fleet back on v2")
            failed = [o for o in load.outcomes if o[2] != 200 or o[3] is not True]
            self.check(load.outcomes and not failed,
                       f"{tag}: {len(load.outcomes)} client requests across the three deploys, "
                       f"{len(failed)} failed or not bit for bit the incumbent's {failed[:3]}")
            stages = {}
            for e in j.events(types={"delivery.stage"}):
                stages.setdefault(os.path.basename(e["attrs"]["archive"]), []).append(
                    e["attrs"]["stage"])
            gates = [(os.path.basename(e["attrs"]["archive"]), e["attrs"]["verdict"])
                     for e in j.events(types={"delivery.gate"})]
            log(f"{tag}: journal delivery.gate {gates}; delivery.stage {stages}")
            self.check(stages.get("v2.zip") == ["gate", "shadow", "canary", "canary_ramp",
                                                "promote_ready", "promoted"]
                       and stages.get("bad.zip") == ["gate", "shadow", "rollback_pending",
                                                     "rolled_back"]
                       and gates == [("v2.zip", "pass"), ("bad.zip", "fail"),
                                     ("bad.zip", "pass")],
                       f"{tag}: the journal's delivery.gate and delivery.stage sequences")
            snap = router.metrics.snapshot()
            log(f"{tag}: shadow mirrors {snap['shadow_mirrors_total']}, canary requests "
                f"{snap['canary_requests_total']}, rollbacks {snap['rollbacks_total']}, "
                f"{counts[fused_lstm_graves.counter.name]} GravesLSTM launches (captures and "
                f"replays) [{self.card}]")
        finally:
            if router is not None:
                router.stop()
            fleet.stop()
            journal.enable(capacity=1024)

    # ------------------------------------------------------------ fleet
    def fleet_phase(self, workdir):
        """Serving's host side, second half, each part a phase of its own:
        BERT-base worker processes under a ``FleetSupervisor``, the kill
        and rolling-deploy drill, router processes over one ``FleetConfig``
        with lease-elected autoscalers, the supervisor's worker lever, and
        a ``Scheduler`` harvesting the card behind an in-process worker.
        Every process started here is stopped and reaped before the phase
        ends; the worker processes' launch counts join the kernels line."""
        import gc
        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.serving import control_plane, fleet
        torch = self.torch
        env = get_environment()
        env.allow_bfloat16()
        saved = os.environ.get("DL4J_TPU_COMPUTE_DTYPE")
        os.environ["DL4J_TPU_COMPUTE_DTYPE"] = "bfloat16"  # what the worker processes read
        gc.collect()
        torch.cuda.empty_cache()
        st = {"stop": []}
        t0 = time.perf_counter()
        try:
            for name, part in (("workers", lambda: self.fleet_workers(workdir, st)),
                               ("drill", lambda: self.fleet_drill(workdir, st)),
                               ("control plane", lambda: self.fleet_control_plane(workdir, st)),
                               ("autoscale", lambda: self.fleet_autoscale(st)),
                               ("scheduler", lambda: self.fleet_scheduler(workdir, st))):
                if name == "workers" or st.get("sup") is not None:
                    self.phase(f"fleet {name}", part)
        finally:
            for stop in reversed(st["stop"]):
                try:
                    stop()
                except Exception as e:  # keep stopping the rest
                    self.failures.append(f"fleet teardown: {type(e).__name__}: {e}")
            if saved is None:
                os.environ.pop("DL4J_TPU_COMPUTE_DTYPE", None)
            else:
                os.environ["DL4J_TPU_COMPUTE_DTYPE"] = saved
        left = fleet.live_worker_pids() + control_plane.live_router_pids()
        self.check(not left, f"fleet: no worker or router process outlives the phase (live: {left})")
        if st.get("run_dir"):
            self.fleet_worker_launches(st["run_dir"])
        log(f"fleet: {time.perf_counter() - t0:.1f} s [{self.card}]")

    def fleet_worker_launches(self, run_dir):
        """The worker processes' own launch counts, written by each at its
        graceful drain: every inference flash launch a multiple of 12 (one
        batch through a replay or a warm-up), nothing else launched; added
        to the kernels line (a SIGKILLed worker writes none)."""
        import glob
        files = sorted(glob.glob(os.path.join(run_dir, "*.launches.json")))
        total = {}
        for f in files:
            with open(f) as fh:
                rec = json.load(fh)
            for k, v in rec["launches"].items():
                total[k] = total.get(k, 0) + int(v)
        flash = total.get("flash_attention", 0)
        others = {k: v for k, v in total.items() if v and k != "flash_attention"}
        self.check(len(files) >= 4 and flash > 0 and flash % BERT_LAYERS == 0 and not others,
                   f"fleet workers: {len(files)} drained worker processes launched {flash} "
                   f"inference flash kernels in all (12 a batch), nothing else: {others}")
        self.add_launches({"flash_attention": flash})

    def fleet_kw(self):
        """Each worker's batcher: BERT-base at bucket 64, one replica."""
        return dict(max_batch_size=BERT_B, buckets=[BERT_B], batch_timeout_ms=5.0, replicas=1,
                    pipeline_depth=SERVING_DEPTH)

    def fleet_workers(self, workdir, st):
        """A ``FleetSupervisor`` starts 2 BERT-base worker processes on cuda
        behind a ``FleetRouter`` in this process: every answer bit for bit
        this process's ``registry.predict``, whichever worker served it;
        nothing captured on traffic; no worker built a kernel."""
        import numpy as np
        from deeplearning4j_tpu_torch.serving import (FleetConfig, FleetRouter, FleetSupervisor,
                                                      ModelRegistry, WorkerSpec, wire)
        tag = "fleet workers"
        path = self.bert_archive(workdir)
        rng = np.random.default_rng(2525)
        reg = ModelRegistry()
        st["stop"].append(lambda: reg.shutdown())
        reg.load("bert", path, device=self.device, replay_manifest=False, save_manifest=False,
                 warmup_example=rng.integers(0, BERT_VOCAB, (1, BERT_T)), **self.fleet_kw())
        xs = [rng.integers(0, BERT_VOCAB, (BERT_B, BERT_T)) for _ in range(4)]
        st.update(reg=reg, xs=xs, want=[reg.predict("bert", x) for x in xs], archive=path)
        run_dir = os.path.join(workdir, "fleet-run")
        st["run_dir"] = run_dir
        config = FleetConfig(os.path.join(workdir, "fleet-config.json"))
        st["config"] = config
        sig = {"__single__": {"shape_tail": [BERT_T], "dtype": "int64"}}
        specs = [WorkerSpec(worker_id=f"fw{i}", model_name="bert", archive=path,
                            batcher_kw=self.fleet_kw(), warmup_signature=sig,
                            straggle=dict(FLEET_STRAGGLE)) for i in range(2)]
        sup = FleetSupervisor(specs, run_dir=run_dir, heartbeat_timeout_s=60.0, config=config)
        t0 = time.time()
        sup.start()
        st["sup"] = sup
        st["stop"].append(sup.stop)
        ready = {w: os.stat(os.path.join(run_dir, f"{w}.port.json")).st_mtime - t0
                 for w in sup.worker_ids()}
        log(f"{tag}: 2 BERT-base worker processes on cuda (bucket {BERT_B}, one replica each, "
            f"spawned together): ready after " + ", ".join(f"{w} {s:.1f} s" for w, s in
                                                          ready.items()) + f" [{self.card}]")
        router = FleetRouter(sup, probe_interval_s=0.05, hedge_enabled=False)
        address = f"127.0.0.1:{router.start(0)}"
        st.update(router=router, address=address)
        st["stop"].append(router.stop)
        self.check(wait_for(lambda: sum(v.ready for v in router.workers().values()) == 2, 60),
                   f"{tag}: both workers ready behind the router")
        eps = sup.endpoints()
        before = {w: http_text(a, "/metrics") for w, a in eps.items()}
        pool = wire.ConnectionPool()
        try:
            served = {}
            for wid in sup.worker_ids():
                others = [w for w in sup.worker_ids() if w != wid]
                for w in others:
                    router.drain(w, timeout_s=30.0)
                served[wid] = [http_wire(pool, address, "bert", x) for x in xs]
                for w in others:
                    router.readmit(w)
                    router.await_ready(w, timeout_s=60.0)
        finally:
            pool.close()
        for wid, got in served.items():
            self.check(all(g[0] == 200 and g[2].get("X-Worker-Id") == wid
                           and arrays_equal(g[1], w) for g, w in zip(got, st["want"])),
                       f"{tag}: {len(xs)} {BERT_B}-row requests served by {wid} in its own "
                       f"process bit for bit this process's registry.predict")
        after = {w: http_text(a, "/metrics") for w, a in eps.items()}
        for w in eps:
            graphs = (metric(before[w], "aot_dispatch_executables_total"),
                      metric(after[w], "aot_dispatch_executables_total"))
            misses = metric(after[w], "compile_cache_misses_total")
            self.check(graphs[0] == graphs[1] == 1 and misses == 0,
                       f"{tag}: {w}: aot_dispatch_executables_total {graphs[0]:.0f} -> "
                       f"{graphs[1]:.0f} over the traffic (nothing captured on it), "
                       f"compile_cache_misses_total {misses:.0f} (no kernel built there)")
        apps = nvidia_smi_apps()
        log(f"{tag}: nvidia-smi compute apps (pid, used_memory): {apps}")

    def fleet_drill(self, workdir, st):
        """8 closed-loop clients through the router while the worker the
        traffic goes to is SIGKILLed: no client request fails, the watchdog
        relaunches it (time to readiness printed); then a rolling deploy to
        a v2 archive with the same weights completes under the same traffic,
        answers unchanged."""
        from deeplearning4j_tpu_torch.serving import wire
        tag = "fleet drill"
        sup, router, address = st["sup"], st["router"], st["address"]
        xs, want = st["xs"], st["want"]
        victim = router.ranked_workers("bert")[0].worker_id
        old = sup.endpoints()[victim]
        pools = [wire.ConnectionPool() for _ in range(FLEET_CLIENTS)]

        def ask(c, k):
            status, out, h, _, _ = http_wire(pools[c], address, "bert", xs[(c + k) % len(xs)])
            return status, (out is not None and arrays_equal(out, want[(c + k) % len(xs)]),
                            h.get("X-Model-Version"))

        v2 = os.path.join(workdir, "bert-base-v2.zip")
        if not os.path.exists(v2):
            os.link(st["archive"], v2)  # the same weights under a new name
        try:
            with Clients(FLEET_CLIENTS, ask) as load:
                time.sleep(0.5)
                t0 = time.perf_counter()
                pid = sup.kill_worker(victim)
                back = wait_for(lambda: victim in sup.endpoints()
                                and sup.endpoints()[victim] != old, 180.0)
                ready_s = time.perf_counter() - t0
                router.await_ready(victim, timeout_s=60.0)
                n_kill = len(load.outcomes)
                sup.prewarm_manifest(v2)
                t0 = time.perf_counter()
                report = router.rolling_deploy(v2, version=2, ready_timeout_s=180.0)
                deploy_s = time.perf_counter() - t0
                time.sleep(0.5)
        finally:
            for p in pools:
                p.close()
        bad = [o[:3] for o in load.outcomes if o[2] != 200 or not (o[3] and o[3][0] is True)]
        self.check(back, f"{tag}: {victim} (pid {pid}, the worker the traffic went to) SIGKILLed "
                         f"and relaunched by the watchdog, ready {ready_s:.1f} s after the kill "
                         f"[{self.card}]")
        versions = sorted({o[3][1] for o in load.outcomes if o[2] == 200})
        self.check(load.outcomes and not bad and versions == ["1", "2"],
                   f"{tag}: {n_kill} requests from {FLEET_CLIENTS} clients across the kill and "
                   f"{len(load.outcomes) - n_kill} across the rolling deploy to v2 "
                   f"({deploy_s:.1f} s, {str(report)[:160]}): {len(bad)} failed or not bit for bit "
                   f"{bad[:3]}; versions served {versions}")

    def fleet_control_plane(self, workdir, st):
        """2 router processes under a ``RouterSupervisor`` over one
        ``FleetConfig``, each with a lease-elected ``SLOAutoscaler``; a
        ``MultiRouterClient`` under 8 clients. The straggled workers burn
        the latency SLO: the leader adds a replica on the worker the traffic
        goes to (captured before it takes traffic); the leader is SIGKILLed
        under load with no client error, and the next decision comes from
        the new holder with a larger ``seq``. No router holds the card."""
        import numpy as np
        from deeplearning4j_tpu_torch.serving import MultiRouterClient, RouterSpec, RouterSupervisor
        tag = "fleet control plane"
        sup, config, xs, want = st["sup"], st["config"], st["xs"], st["want"]
        target = st["router"].ranked_workers("bert")[0].worker_id
        graphs0 = metric(http_text(sup.endpoints()[target], "/metrics"),
                         "aot_dispatch_executables_total")
        specs = [RouterSpec(router_id=f"fr{i}", config_path=config.path, lease_s=FLEET_LEASE_S,
                            router_kw={"probe_interval_s": 0.1, "hedge_enabled": False},
                            slo_windows_s=[10, 60], slo_target=dict(FLEET_SLO),
                            autoscaler=dict(FLEET_AUTOSCALER)) for i in range(2)]
        rsup = RouterSupervisor(specs, run_dir=os.path.join(workdir, "router-run"),
                                heartbeat_timeout_s=60.0, max_restarts=2)
        t0 = time.perf_counter()
        rsup.start()
        st["stop"].append(rsup.stop)
        log(f"{tag}: 2 router processes ready in {time.perf_counter() - t0:.1f} s")
        self.check(wait_for(lambda: len(config.routers()) == 2, 30.0),
                   f"{tag}: both routers registered in the shared config")
        # the card holders are this process and the workers, never a router:
        # a context holds its card's device file open, which /proc shows in
        # this pid namespace (nvidia-smi reports pids of another one, so it
        # only counts the holders)
        apps = nvidia_smi_apps()
        workers, routers = sup.managed_pids(), rsup.managed_pids()
        marks = {pid: card_marks(pid) for pid in workers + routers}
        holds = {pid: any(re.fullmatch(r"/dev/nvidia\d+", m) for m in ms)
                 for pid, ms in marks.items()}
        self.check(routers and workers and not any(holds[p] for p in routers)
                   and all(holds[p] for p in workers) and len(apps) == 1 + len(workers),
                   f"{tag}: no router process holds a card's device file open, every worker "
                   f"does (routers {routers}, workers {workers}; from /proc: {marks}); "
                   f"nvidia-smi --query-compute-apps counts {len(apps)} card holders, this "
                   f"process and its {len(workers)} workers ({apps})")
        client = MultiRouterClient(config=config, timeout_s=120.0)

        def ask(c, k):
            x = xs[(c + k) % len(xs)]
            status, payload = client.predict("bert", x, timeout_ms=60000)
            out = payload.get("outputs")
            return status, isinstance(out, np.ndarray) and arrays_equal(out, want[(c + k) % len(xs)])

        routers = config.routers()

        def decisions(rid):
            return http_json_get(routers[rid], "/v1/autoscaler")

        acted = leader = None
        try:
            with Clients(FLEET_CLIENTS, ask) as load:
                t0 = time.perf_counter()

                def replica_added():
                    nonlocal acted, leader
                    for rid in ("fr0", "fr1"):
                        rep = decisions(rid)
                        for d in rep["decisions"]:
                            if d["action"] == "scale_up_replica" and d["ok"]:
                                acted, leader = d, rid
                                return True
                    return False

                added = wait_for(replica_added, 60.0)
                add_s = time.perf_counter() - t0
                seq0 = decisions(leader)["election"]["seq"] if leader else None
                n_before = len(load.outcomes)
                survivor = "fr1" if leader == "fr0" else "fr0"
                if leader is not None:
                    rsup.kill_router(leader)
                took = False
                if leader is not None:
                    def new_leader():
                        rep = decisions(survivor)
                        return rep["election"]["role"] == "leader" and any(
                            d["role"] == "leader" and d["model"] == "bert"
                            for d in rep["decisions"])
                    took = wait_for(new_leader, 30.0)
                time.sleep(0.5)
        finally:
            client.close()
        bad = [o[:3] for o in load.outcomes if o[2] != 200 or o[3] is not True]
        self.check(load.outcomes and not bad,
                   f"{tag}: {n_before} requests from {FLEET_CLIENTS} clients through the "
                   f"MultiRouterClient before the leader's SIGKILL and "
                   f"{len(load.outcomes) - n_before} after: {len(bad)} failed or not bit for "
                   f"bit {bad[:3]}; failovers {client.snapshot()['failovers_total']}")
        self.check(added and acted["worker"] == target,
                   f"fleet autoscale: the leader ({leader}) added a replica on {target}, the "
                   f"worker the traffic goes to, {add_s:.1f} s into the straggled traffic: "
                   f"{acted and {k: acted[k] for k in ('action', 'ok', 'role', 'worker', 'detail')}}"
                   f"; burn fast/slow "
                   f"{acted and (acted['burn']['burn_fast'], acted['burn']['burn_slow'])}")
        cap = http_json_get(sup.endpoints()[target], "/v1/capacity")["models"]["bert"]
        graphs1 = metric(http_text(sup.endpoints()[target], "/metrics"),
                         "aot_dispatch_executables_total")
        self.check(cap["replicas"] == 2 and graphs1 == graphs0 + 1 == cap["aot_executables"],
                   f"fleet autoscale: {target} serves from {cap['replicas']} replicas, "
                   f"{graphs0:.0f} -> {graphs1:.0f} graphs (the new replica captured at its "
                   f"warm-up, before it took traffic; every answer above bit for bit)")
        if took:
            rep = decisions(survivor)
            after = [d for d in rep["decisions"] if d["role"] == "leader" and d["model"] == "bert"]
            self.check(rep["election"]["seq"] > seq0,
                       f"fleet autoscale: after {leader}'s SIGKILL the next decision "
                       f"({after[0]['action']}) comes from {survivor}, the new holder, seq "
                       f"{seq0} -> {rep['election']['seq']}; every decision in /v1/autoscaler")
        else:
            self.check(False, f"fleet autoscale: no decision from a new lease holder after "
                              f"{leader}'s SIGKILL")
        relaunched = wait_for(lambda: len(rsup.endpoints()) == 2, 60.0)
        self.check(relaunched and leader in config.routers(),
                   f"{tag}: {leader} relaunched by the watchdog and registered again")

    def fleet_autoscale(self, st):
        """The worker lever lives beside the supervisor (a router process
        holds none, as in the JAX package): an ``SLOAutoscaler`` with the
        fleet over this process's router; with the target's replicas at
        the max it clones the worker's spec and adds a worker process
        (time to ready printed). The decision is in ``/v1/autoscaler``."""
        from deeplearning4j_tpu_torch.runtime import journal
        from deeplearning4j_tpu_torch.serving import (AutoscalerConfig, FleetRouter,
                                                      SLOAutoscaler, wire)
        from deeplearning4j_tpu_torch.serving.slo import SLOMonitor, SLOTarget
        tag = "fleet autoscale"
        sup, xs, want = st["sup"], st["xs"], st["want"]
        j = journal.enable(capacity=16384)
        router = FleetRouter(sup, probe_interval_s=0.05, hedge_enabled=False,
                             slo=SLOMonitor(target=SLOTarget(**FLEET_SLO), windows_s=(10, 60)))
        address = f"127.0.0.1:{router.start(0)}"
        st["stop"].append(router.stop)
        self.check(wait_for(lambda: sum(v.ready for v in router.workers().values()) == 2, 60),
                   f"{tag}: a second router in this process sees both workers")
        auto = SLOAutoscaler(router, fleet=sup,
                             config=AutoscalerConfig(**FLEET_AUTOSCALER, max_workers=3))
        pools = [wire.ConnectionPool() for _ in range(FLEET_CLIENTS)]

        def ask(c, k):
            status, out, _, _, _ = http_wire(pools[c], address, "bert", xs[(c + k) % len(xs)])
            return status, out is not None and arrays_equal(out, want[(c + k) % len(xs)])

        try:
            with Clients(FLEET_CLIENTS, ask) as load:
                auto.start()
                st["stop"].append(auto.stop)
                grew = wait_for(lambda: any(d["action"] == "scale_up_worker" and d["ok"]
                                            for d in auto.decision_log()), 120.0)
                time.sleep(0.5)
        finally:
            auto.stop()
            for p in pools:
                p.close()
        log_ = auto.decision_log()
        d = next((d for d in log_ if d["action"] == "scale_up_worker"), None)
        new = (d or {}).get("detail", {}).get("worker_id")
        spawn = [e for e in j.events(types=("fleet.worker_spawn",))
                 if e["attrs"].get("worker") == new]
        ready_s = (os.stat(os.path.join(sup.run_dir, f"{new}.port.json")).st_mtime
                   - spawn[0]["ts"]) if new and spawn else None
        self.check(grew and new in sup.endpoints(),
                   f"{tag}: replicas at the max on {d and d['worker']}, the autoscaler added "
                   f"worker {new} (clone_spec + add_worker), ready {ready_s and round(ready_s, 1)} "
                   f"s after its spawn [{self.card}]; decisions "
                   f"{[x['action'] for x in log_]}")
        served = http_json_get(address, "/v1/autoscaler")["decisions"]
        self.check([x["action"] for x in served] == [x["action"] for x in log_],
                   f"{tag}: /v1/autoscaler serves the {len(served)} decisions")
        bad = [o[:3] for o in load.outcomes if o[2] != 200 or o[3] is not True]
        self.check(load.outcomes and not bad,
                   f"{tag}: {len(load.outcomes)} requests while the fleet grew: {len(bad)} "
                   f"failed or not bit for bit {bad[:3]}")
        if new in sup.endpoints():
            text = http_text(sup.endpoints()[new], "/metrics")
            pool = wire.ConnectionPool()
            try:
                g = http_wire(pool, sup.endpoints()[new], "bert", xs[0])
            finally:
                pool.close()
            self.check(g[0] == 200 and arrays_equal(g[1], want[0])
                       and metric(text, "compile_cache_misses_total") == 0,
                       f"{tag}: {new} answers bit for bit and built no kernel")

    def fleet_scheduler(self, workdir, st):
        """An in-process ``ModelServer`` serves BERT-base with a
        ``Scheduler`` attached: a fine-tune job (B=64, 20 steps) run through
        once, and once preempted by traffic and resumed, the two bit for bit
        (losses and weights); a replica added while the job runs; then eval,
        score, a sweep and a flywheel into a gated deploy."""
        import numpy as np
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
        from deeplearning4j_tpu_torch.serving import (JobStore, ModelServer, Scheduler,
                                                      SchedulerConfig, FleetConfig, capacity, wire)
        from deeplearning4j_tpu_torch.serving.scheduler import (FineTuneRun, FlywheelRun,
                                                                capacity_signals)
        torch = self.torch
        tag = "fleet scheduler"
        reg, xs, want, path = st["reg"], st["xs"], st["want"], st["archive"]
        srv = ModelServer(reg, worker_id="fleet-sched")
        address = f"127.0.0.1:{srv.start(0)}"
        st["stop"].append(srv.stop)
        rng = np.random.default_rng(2727)
        n = BERT_B * 4
        labels = rng.integers(0, 2, n)
        data = os.path.join(workdir, "finetune.npz")
        np.savez(data, x=rng.integers(0, BERT_VOCAB, (n, BERT_T)),
                 y=np.eye(2, dtype=np.float32)[labels], labels=labels)
        finals, stepped, splits, fly_features = {}, {}, {}, {}

        class Run(FineTuneRun):
            """The fine-tune runner, keeping its final weights on the card and
            its exchange split, and signalling its steps."""

            def step(self):
                done = super().step()
                stepped.setdefault(self.job["id"], threading.Event())
                if self.steps_done >= FLEET_PREEMPT_AFTER:
                    stepped[self.job["id"]].set()
                return done

            def result(self):
                finals[self.job["id"]] = [t.detach().clone()
                                          for t in tree_leaves(self.trainer.net._params)]
                splits[self.job["id"]] = self.trainer.stats.headline()
                return super().result()

        class Fly(FlywheelRun):
            """The flywheel runner, keeping the dtype and shape of its features."""

            def __init__(self, job, ctx):
                super().__init__(job, ctx)
                if self.net is not None:
                    fly_features[job["id"]] = (self.x.dtype.name, self.x.shape)

        store = JobStore(FleetConfig(os.path.join(workdir, "jobs.json")))
        sched = Scheduler(store, signals=capacity_signals(reg), worker_id="fleet-sched",
                          registry=reg, config=SchedulerConfig(tick_s=0.05),
                          runners={"finetune": Run, "flywheel": Fly})
        srv.scheduler = sched
        sched.start()
        st["stop"].append(sched.stop)
        metrics = reg.get("bert").metrics

        def job(jtype, payload, timeout_s=300.0):
            jid = store.submit(jtype, payload)
            wait_for(lambda: store.get(jid)["state"] in ("completed", "failed", "cancelled"),
                     timeout_s)
            return jid, store.get(jid)

        def finetune(name):
            return {"archive": path, "data": data, "steps": FLEET_FT_STEPS, "batch_size": BERT_B,
                    "seed": 3, "threshold": 0.0,
                    "checkpoint_dir": os.path.join(workdir, f"ft-{name}")}

        # ---- run A: uninterrupted, a replica added while it runs
        metrics.reset_window()
        torch.cuda.synchronize()
        for c in all_counters():
            c.reset()
        t0 = time.perf_counter()
        jid_a = store.submit("finetune", finetune("a"))
        wait_for(lambda: jid_a in stepped and stepped[jid_a].is_set(), 120.0)
        graphs0 = reg.get("bert").batcher.compile_count()
        t1 = time.perf_counter()
        status, _, body = http_post(address, "/v1/models/bert/replicas", {"delta": 1})
        resize_s = time.perf_counter() - t1
        running = store.get(jid_a)["state"] in ("started", "resumed")
        pool = wire.ConnectionPool()
        try:
            probe = [http_wire(pool, address, "bert", x) for x in xs]
        finally:
            pool.close()
        wait_for(lambda: store.get(jid_a)["state"] in ("completed", "failed"), 300.0)
        run_a = store.get(jid_a)
        a_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = {c.name: c.value for c in all_counters()}
        self.check(status == 200 and running
                   and reg.get("bert").batcher.compile_count() == graphs0 + 1
                   and all(g[0] == 200 and arrays_equal(g[1], w) for g, w in zip(probe, want)),
                   f"{tag}: a replica added while the fine-tune ran ({resize_s:.2f} s, job "
                   f"{'running' if running else 'not running'}; its capture and the job's steps "
                   f"exclude each other): graphs {graphs0} -> "
                   f"{reg.get('bert').batcher.compile_count()}, {len(xs)} answers after bit for "
                   f"bit: {body[:120]!r}")
        steps = FLEET_FT_STEPS
        want_counts = {fa.lse_counter.name: BERT_LAYERS * steps,
                       fa.bwd_dq_counter.name: BERT_LAYERS * steps,
                       fa.bwd_dkv_counter.name: BERT_LAYERS * steps}
        got_counts = {k: counts[k] for k in want_counts}
        self.check(run_a["state"] == "completed" and got_counts == want_counts,
                   f"{tag}: fine-tune job ({steps} steps of {BERT_B} x {BERT_T}, dropout 0.1) "
                   f"{run_a['state']} in {a_s:.1f} s ({1e3 * a_s / steps:.0f} ms a step, the "
                   f"host exchange: {splits.get(jid_a)}); {got_counts} launches (12 + 12 + 12 a "
                   f"step) [{self.card}]; losses "
                   f"{[round(x, 4) for x in (run_a['result'] or {}).get('losses', [])[:3]]}...")
        self.add_launches(got_counts)
        self.add_launches({fa.counter.name: counts[fa.counter.name]})
        http_post(address, "/v1/models/bert/replicas", {"delta": -1})

        # ---- run B: traffic preempts it, then it resumes
        pools = [wire.ConnectionPool() for _ in range(FLEET_CLIENTS)]

        def ask(c, k):
            status, out, _, _, _ = http_wire(pools[c], address, "bert", xs[(c + k) % len(xs)])
            return status, out is not None and arrays_equal(out, want[(c + k) % len(xs)])

        t0 = time.perf_counter()
        jid_b = store.submit("finetune", finetune("b"))
        wait_for(lambda: jid_b in stepped and stepped[jid_b].is_set(), 120.0)
        try:
            metrics.reset_window()
            with Clients(FLEET_CLIENTS, ask) as load:
                preempted = wait_for(lambda: store.get(jid_b)["state"] == "preempted", 60.0)
                progress = store.get(jid_b)["progress"]
                time.sleep(0.5)
        finally:
            for p in pools:
                p.close()
        metrics.reset_window()
        wait_for(lambda: store.get(jid_b)["state"] in ("completed", "failed"), 300.0)
        run_b = store.get(jid_b)
        b_s = time.perf_counter() - t0
        bad = [o[:3] for o in load.outcomes if o[2] != 200 or o[3] is not True]
        self.check(load.outcomes and not bad,
                   f"{tag}: {len(load.outcomes)} requests from {FLEET_CLIENTS} clients while the "
                   f"job ran and was preempted: {len(bad)} failed or not bit for bit the idle "
                   f"answers {bad[:3]}")
        same_losses = (run_a.get("result") or {}).get("losses") == \
            (run_b.get("result") or {}).get("losses")
        fa_, fb_ = finals.get(jid_a), finals.get(jid_b)
        same_weights = fa_ is not None and fb_ is not None and len(fa_) == len(fb_) and all(
            a.shape == b.shape and a.dtype == b.dtype and torch.equal(
                a.contiguous().reshape(-1).view(torch.uint8),
                b.contiguous().reshape(-1).view(torch.uint8))
            for a, b in zip(fa_, fb_))
        self.check(preempted and run_b["state"] == "completed" and same_losses and same_weights,
                   f"{tag}: traffic preempted the second fine-tune at step "
                   f"{progress.get('steps_done')} (the capacity signal), it resumed and completed "
                   f"in {b_s:.1f} s; its {steps} losses and final weights bit for bit the "
                   f"uninterrupted run's: losses {same_losses}, weights {same_weights}")
        snap = sched.harvest_snapshot()
        self.check(snap["preemptions_total"] >= 1 and snap["resumes_total"] >= 1,
                   f"{tag}: harvested {snap['harvested_busy_s']:.2f} s of the card so far "
                   f"(preemptions {snap['preemptions_total']}, resumes {snap['resumes_total']})")

        # ---- eval through the batcher, score, a sweep: the harvest window
        metrics.reset_window()
        sched.reset_harvest()
        ev = os.path.join(workdir, "eval.npz")
        ex = rng.integers(0, BERT_VOCAB, (2 * BERT_B, BERT_T))
        el = rng.integers(0, 2, 2 * BERT_B)
        np.savez(ev, x=ex, labels=el)
        _, rec = job("eval", {"model": "bert", "data": ev, "batch_size": BERT_B})
        direct = np.concatenate([np.asarray(reg.predict("bert", ex[i:i + BERT_B]))
                                 for i in range(0, len(ex), BERT_B)])
        acc = round(float((direct.argmax(-1) == el).mean()), 6)
        self.check(rec["state"] == "completed" and rec["result"]["accuracy"] == acc,
                   f"{tag}: eval through the batcher {rec['result']} = the direct predict's "
                   f"accuracy {acc}")
        out = os.path.join(workdir, "scores.npz")
        _, rec = job("score", {"archive": path, "data": ev, "batch_size": BERT_B, "out": out})
        scores = np.load(out)["outputs"] if rec["state"] == "completed" else None
        err = None if scores is None else float(np.abs(scores - direct).max())
        self.check(scores is not None and scores.shape == direct.shape
                   and np.isfinite(scores).all() and err <= BERT_TOL,
                   f"{tag}: score wrote {None if scores is None else scores.shape} outputs, max "
                   f"abs err {err} against the served answers (tolerance {BERT_TOL})")
        sw = os.path.join(workdir, "sweep.npz")
        sx = rng.normal(size=(64, 8)).astype(np.float32)
        np.savez(sw, x=sx, y=np.eye(4, dtype=np.float32)[rng.integers(0, 4, 64)])
        _, rec = job("sweep", {"data": sw, "space": FLEET_SWEEP_SPACE, "mode": "random",
                               "trials": len(FLEET_SWEEP_TRIALS), "seed": 7, "steps": 5,
                               "batch_size": 16, "base": {"updater": "sgd"}})
        trials = [r["params"] for r in (rec.get("result") or {}).get("results", [])]
        bare = [{k: v for k, v in t.items() if k in FLEET_SWEEP_SPACE} for t in trials]
        self.check(rec["state"] == "completed" and bare == FLEET_SWEEP_TRIALS
                   and all(np.isfinite(r["score"]) for r in rec["result"]["results"]),
                   f"{tag}: sweep of {len(trials)} trials, the JAX package's trial sequence for "
                   f"seed 7; scores {[r['score'] for r in (rec.get('result') or {}).get('results', [])]}")
        cap = http_json_get(address, "/v1/capacity")
        util = cap["utilization"]
        plain = capacity.device_utilization(cap["models"], harvested_busy_s=0.0)
        self.check(util["harvested_busy_s"] > 0
                   and util["device_idle_fraction"] < plain["device_idle_fraction"],
                   f"{tag}: over the eval, score and sweep jobs the scheduler harvested "
                   f"{util['harvested_busy_s']:.3f} s of a {util['device_window_s']:.3f} s "
                   f"window: device_idle_fraction {plain['device_idle_fraction']:.4f} without "
                   f"the harvest, {util['device_idle_fraction']:.4f} with it [{self.card}]")
        self.fleet_flywheel(workdir, store, sched, fly_features)

    def fleet_flywheel(self, workdir, store, sched, seen):
        """A flywheel job on BERT-base: FLEET_FLY_ROWS labeled rows of token
        ids at T=128 (a ``FeedbackLog`` joined to an access log) fine-tune
        the served archive by transfer learning on the card, on integer ids
        (float ids would round to other tokens under bf16), and its
        candidate goes through a gated rolling deploy over two in-process
        BERT-base workers under client traffic. Its launches (the workers'
        replays, the job's training steps) join the kernels line."""
        import numpy as np
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        from deeplearning4j_tpu_torch.runtime import journal
        from deeplearning4j_tpu_torch.serving import FleetRouter, ModelRegistry, ModelServer, wire
        from deeplearning4j_tpu_torch.serving.delivery import (DeliveryConfig, FeedbackLog,
                                                               GoldenSet)
        from deeplearning4j_tpu_torch.serving.slo import SLOTarget
        torch = self.torch
        tag = "fleet scheduler"
        d = os.path.join(workdir, "flywheel")
        os.makedirs(d, exist_ok=True)
        rng = np.random.default_rng(2929)
        base = os.path.join(d, "bert.zip")
        try:
            os.link(self.bert_archive(workdir), base)
        except OSError:
            shutil.copyfile(self.bert_archive(workdir), base)
        n = FLEET_FLY_ROWS
        ids = rng.integers(0, BERT_VOCAB, (n, BERT_T))
        labels = rng.integers(0, 2, n)
        GoldenSet(ids[:4], max_delta=1.0).save(GoldenSet.sidecar(base))
        access, labeled = os.path.join(d, "access.jsonl"), os.path.join(d, "labeled.jsonl")
        with open(access, "w") as f:
            for i in range(n):
                f.write(json.dumps({"log": "dl4j_tpu_access", "trace_id": f"t{i}",
                                    "model": "bert", "outcome": 200}) + "\n")
        fb = FeedbackLog(access_log_path=access, out_path=labeled)
        for i in range(n):
            fb.record(f"t{i}", label=int(labels[i]), inputs=ids[i].tolist())
        kw = dict(self.fleet_kw(), warmup_example=ids[:1], replay_manifest=False,
                  save_manifest=False)

        def launch(wid, archive, version):
            reg = ModelRegistry()
            srv = ModelServer(reg, worker_id=wid)
            try:
                reg.load("bert", archive, device=self.device, version=version, **kw)
                srv.start(0)
            except Exception:
                srv.stop(shutdown_registry=True)
                raise
            return srv

        torch.cuda.synchronize()
        for c in all_counters():
            c.reset()
        fleet = InProcFleet(launch)
        router = None
        try:
            fleet.add("b0", base)
            fleet.add("b1", base)
            router = FleetRouter(fleet, probe_interval_s=0.05, hedge_enabled=False)
            address = f"127.0.0.1:{router.start(0)}"
            self.check(wait_for(lambda: sum(v.ready for v in router.workers().values()) == 2),
                       f"{tag}: the flywheel's two BERT-base workers ready")
            cfg = DeliveryConfig(shadow_fraction=1.0, shadow_min_samples=4,
                                 shadow_max_disagreement=1.0, canary_fractions=(0.5, 1.0),
                                 canary_min_requests=6,
                                 canary_target=SLOTarget(availability=0.5, latency_ms=5000.0,
                                                         latency_target=0.5),
                                 canary_window_s=30, stage_timeout_s=120.0)
            j = journal.enable(capacity=16384)
            sched.ctx.deploy_fn = lambda archive, payload: router.rolling_deploy(
                archive, version=2, strategy="gated", model="bert", delivery_config=cfg,
                ready_timeout_s=120)
            pools = [wire.ConnectionPool() for _ in range(3)]

            def ask(c, k):
                status, out, _, _, _ = http_wire(pools[c], address, "bert",
                                                 ids[(c + k) % 16][None])
                return status, out is not None and bool(np.isfinite(out).all())

            t0 = time.perf_counter()
            try:
                with Clients(3, ask) as load:
                    jid = store.submit("flywheel", {
                        "base_archive": base, "model": "bert", "feedback_file": labeled,
                        "out_archive": os.path.join(d, "candidate.zip"), "min_examples": BERT_B,
                        "max_epochs": FLEET_FLY_EPOCHS, "patience": FLEET_FLY_EPOCHS,
                        "lr": 1e-3, "batch_size": BERT_B})
                    wait_for(lambda: store.get(jid)["state"] in ("completed", "failed"), 300.0)
                    rec = store.get(jid)
            finally:
                for p in pools:
                    p.close()
            fly_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            counts = {c.name: c.value for c in all_counters()}
            res = rec.get("result") or {}
            stages = [e["attrs"].get("stage") for e in j.events(types=("delivery.stage",))]
            bad = [o[:3] for o in load.outcomes if o[2] != 200 or o[3] is not True]
            feats = seen.get(jid)
            self.check(rec["state"] == "completed" and res.get("status") == "trained"
                       and res.get("examples") == n and np.isfinite(res.get("best_score", np.nan))
                       and feats is not None and feats[0].startswith("int")
                       and feats[1] == (n, BERT_T) and res.get("deployed")
                       and (res.get("deploy") or {}).get("verdict") == "promoted" and not bad,
                       f"{tag}: flywheel job on BERT-base {rec['state']} ({rec.get('error')}) in "
                       f"{fly_s:.1f} s: {res.get('examples')} labeled rows of {BERT_T} token ids "
                       f"(features {feats}), {res.get('epochs')} epochs of {n // BERT_B} steps, "
                       f"best loss {res.get('best_score')}; candidate "
                       f"{(res.get('deploy') or {}).get('verdict')} through the gated deploy "
                       f"(stages {stages}); {len(load.outcomes)} client requests, {len(bad)} "
                       f"failed [{self.card}]")
            steps = FLEET_FLY_EPOCHS * (n // BERT_B)
            trained = {k: counts.get(k, 0) for k in (fa.lse_counter.name, fa.bwd_dq_counter.name,
                                                      fa.bwd_dkv_counter.name)}
            self.check(trained[fa.bwd_dq_counter.name] == trained[fa.bwd_dkv_counter.name]
                       == BERT_LAYERS * steps <= trained[fa.lse_counter.name]
                       and counts.get(fa.counter.name, 0) > 0,
                       f"{tag}: the flywheel's {steps} training steps launched {trained} (12 + "
                       f"12 + 12 a step); the workers and the job's scoring "
                       f"{counts.get(fa.counter.name, 0)} inference flash kernels")
            self.add_launches(counts)
        finally:
            if router is not None:
                router.stop()
            fleet.stop()

    def times_phase(self):
        """Every kernel's time at its main path's shape: rows 1-6, 7-9,
        10-12 and 13."""
        self.lstm_times()
        self.gru_times()
        self.flash_times()
        self.dropout_times()
        self.short_times()
        self.conv_stats_times()

    def lstm_times(self):
        """Each LSTM kernel's time at the serving/training shape, bf16, with
        the main path's arguments (GravesLSTM: peepholes, no mask): its own
        device time (``torch.profiler``) with back-to-back CUDA events
        beside it, the time per step, the kernel the profiler names, beside
        its bound and the share of it reached, its plain version's time and,
        for the plain cell, cuDNN's."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import fused_lstm as fl
        T, B, H = KERNEL_SHAPES[0]
        dt = torch.bfloat16
        cudnn = self.cudnn_ms(torch.nn.LSTM, T, B, H, dt)
        log(f"torch.nn.LSTM (cuDNN), layer 0's work incl. its input projection, T={T} B={B} "
            f"H={H} bf16: inference {cudnn['infer']:.3f} ms, training forward "
            f"{cudnn['fwd']:.3f} ms + backward {cudnn['bwd']:.3f} ms = "
            f"{cudnn['fwd'] + cudnn['bwd']:.3f} ms")
        pallas = "deeplearning4j_tpu/ops/pallas/"
        specs = [("fused_graves_lstm", True, pallas + "fused_lstm_graves.py:146",
                  pallas + "fused_lstm_graves.py:241"),
                 ("fused_lstm", False, pallas + "fused_lstm.py:162", pallas + "fused_lstm.py:242")]
        log_clocks("LSTM times")
        for cell, peep, fwd_line, bwd_line in specs:
            mod = self.cell_module(cell)
            a = lstm_inputs(T, B, H, dt, self.device, seed=5, peep=peep, mask=False)
            fwd = (a["zx"], a["w_rec"], a["peep"], a["h0"], a["c0"], None)
            outs = fl.launch_lstm_fwd(*fwd, mod.save_counter, save=True)
            g = torch.Generator().manual_seed(6)
            cot = [torch.randn(s_, generator=g).to(dt).to(self.device)
                   for s_ in ((T, B, H), (B, H), (B, H))]
            bwd = (*cot, outs[3], outs[4], a["c0"], a["w_rec"], a["peep"], None)
            grads = fl.launch_lstm_bwd(*bwd, mod.bwd_counter)
            lib = {} if peep else cudnn  # PyTorch has no peephole LSTM
            self.time_recurrent("graves" if peep else "lstm", mod, LSTM_ROW_GROUP, 4, [
                ("lstm_fwd.cu", fwd_line, fwd, outs[:3],
                 lambda: fl.launch_lstm_fwd(*fwd, mod.counter),
                 lambda: fl.lstm_reference(*fwd), lib.get("infer")),
                ("lstm_fwd.cu", fwd_line, fwd, outs,
                 lambda: fl.launch_lstm_fwd(*fwd, mod.save_counter, save=True),
                 lambda: fl.lstm_reference(*fwd, save=True), lib.get("fwd")),
                ("lstm_bwd.cu", bwd_line, bwd, grads,
                 lambda: fl.launch_lstm_bwd(*bwd, mod.bwd_counter),
                 lambda: fl.lstm_bwd_reference(*bwd), lib.get("bwd"))])

    def time_recurrent(self, cell, mod, pair, gates, rows):
        """The times of one cell's three kernels (inference forward, saving
        forward, backward of ``mod``; ``rows``: source, the TPU kernel it
        replaces, inputs, outputs, the launch, the plain version, cuDNN's ms
        or None) at KERNEL_SHAPES[0] in bf16: device time
        (``torch.profiler``) with back-to-back CUDA events beside it, the
        time per step, the kernel the profiler names (``pair``), the bound
        of the recurrent product (``gates`` gate columns per unit) and the
        share of it reached; then the kernels' share of the cell's training
        step and serving request."""
        T, B, H = KERNEL_SHAPES[0]
        csrc = "deeplearning4j_tpu_torch/ops/kernels/csrc/"
        prefix = pair[0].split("_")[0]  # lstm or gru: either design's kernels
        names = (mod.counter.name, mod.save_counter.name, mod.bwd_counter.name)
        for name, (src, replaces, ins, outs, kern, plain, lib) in zip(names, rows):
            ms = self.device_ms(kern, (f"{prefix}_fwd", f"{prefix}_bwd"))
            events_ms = cuda_ms(kern, reps=10)
            ran = self.recurrent_kernels(kern, {pair[name == mod.bwd_counter.name]: 1})
            plain_ms = cuda_ms(plain, reps=3, warmup=1)
            bound_ms, bound_by = bound(list(ins) + list(outs), 2.0 * T * B * H * gates * H,
                                       self.torch.bfloat16)
            self.kernels.setdefault(name, {}).update({
                "name": name, "route": "cuda", "source": csrc + src, "replaces": replaces,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib})
            vs = "" if lib is None else f"; cuDNN {lib:.3f} ms ({ms / lib:.2f}x it)"
            log(f"{name}: {ms:.4f} ms per launch by device time (CUDA events "
                f"{events_ms:.4f}), {1e3 * ms / T:.2f} us a step at T={T} B={B} H={H} bf16, "
                f"{' + '.join(ran)}; bound {bound_ms:.4f} ms ({bound_by}), "
                f"{100 * bound_ms / ms:.1f}% of it reached; plain version "
                f"{plain_ms:.3f} ms{vs}")
        ms = {name: self.kernels[name]["ms"] for name in names}
        tag = CHAR_RNN_TAGS[cell]
        step = self.train_step_ms.get(cell)
        if step is not None:
            kms = LAYERS * (ms[names[1]] + ms[names[2]])
            log(f"{tag} training step: the recurrent kernels take {LAYERS} x "
                f"(forward + backward) = {kms:.2f} ms of the {step:.2f} ms median step "
                f"({100 * kms / step:.0f}%)")
        p50 = self.serve_p50_ms.get(cell)
        if p50 is not None:
            kms = LAYERS * ms[names[0]]
            log(f"{tag} one {SERVE_B}-row request: the {LAYERS} recurrent launches take "
                f"{kms:.2f} ms of the {p50:.2f} ms p50 ({100 * kms / p50:.0f}%)")

    def gru_times(self):
        """Each GRU kernel's time at B=64, T=256, H=512 bf16 with the main
        path's arguments: its own device time (``torch.profiler``) with
        back-to-back CUDA events beside it, the time per step, the kernel
        the profiler names, beside its bound and the share of it reached,
        its plain version's time and ``torch.nn.GRU``'s (cuDNN, the same
        reset-after cell; a yardstick the port never calls: inference,
        training forward, backward); their share of a serving request and
        of a training step."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import fused_gru as fgru
        T, B, H = KERNEL_SHAPES[0]
        dt = torch.bfloat16
        cudnn = self.cudnn_ms(torch.nn.GRU, T, B, H, dt)
        log(f"torch.nn.GRU (cuDNN), layer 0's work incl. its input projection, T={T} B={B} "
            f"H={H} bf16: inference {cudnn['infer']:.3f} ms, training forward "
            f"{cudnn['fwd']:.3f} ms + backward {cudnn['bwd']:.3f} ms = "
            f"{cudnn['fwd'] + cudnn['bwd']:.3f} ms")
        a = gru_inputs(T, B, H, dt, self.device, seed=5)
        fwd = (a["zx"], a["w_rec"], a["h0"])
        outs = fgru.launch_gru_fwd(*fwd, fgru.save_counter, save=True)
        g = torch.Generator().manual_seed(6)
        cot = [torch.randn(s_, generator=g).to(dt).to(self.device) for s_ in ((T, B, H), (B, H))]
        bwd = (*cot, outs[2], outs[3], outs[0], a["h0"], a["w_rec"])
        grads = fgru.launch_gru_bwd(*bwd, fgru.bwd_counter)
        pallas = "deeplearning4j_tpu/ops/pallas/fused_gru.py"
        log_clocks("GRU times")
        self.time_recurrent("gru", fgru, GRU_ROW_GROUP, 3, [
            ("gru_fwd.cu", f"{pallas}:147", fwd, outs[:2],
             lambda: fgru.launch_gru_fwd(*fwd, fgru.counter),
             lambda: fgru.gru_reference(*fwd), cudnn["infer"]),
            ("gru_fwd.cu", f"{pallas}:147", fwd, outs,
             lambda: fgru.launch_gru_fwd(*fwd, fgru.save_counter, save=True),
             lambda: fgru.gru_reference(*fwd, save=True), cudnn["fwd"]),
            ("gru_bwd.cu", f"{pallas}:224", bwd, grads,
             lambda: fgru.launch_gru_bwd(*bwd, fgru.bwd_counter),
             lambda: fgru.gru_bwd_reference(*bwd), cudnn["bwd"])])

    def flash_times(self):
        """The flash kernel's time in bf16 at BERT-base serving's shape
        without a mask (the main path's arguments: served requests carry
        none) and with one, and at the long-context causal shape, by its
        own device time (``torch.profiler``) with the CUDA-event figure of
        back-to-back launches beside it: against its bound (and the share
        of the bound it reaches), the saving instance, the plain version
        and ``scaled_dot_product_attention`` with the same mask or
        ``is_causal`` (a yardstick the port never calls; its device time is
        that of every kernel of the call); then flash's share of one
        64-row request and of a fine-tuning step."""
        torch = self.torch
        import torch.nn.functional as F
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        dt = torch.bfloat16
        main = None
        log_clocks("flash times")
        for shape in (FLASH_SHAPES[0], FLASH_SHAPES[1], FLASH_SHAPES[2]):
            b, h, t_q, t_k, d, d_v, masked, causal = shape
            (q, k, v), mask = flash_inputs(b, h, t_q, t_k, d, d_v, dt, self.device, seed=9,
                                           mask=masked)
            bias = fa.key_bias(mask, b, t_k)
            sdpa_mask = None if mask is None else mask[:, None, None, :]
            infer = lambda: fa.launch_flash_fwd(q, k, v, bias, causal, fa.counter)  # noqa: E731
            save = lambda: fa.launch_flash_fwd(q, k, v, bias, causal,  # noqa: E731
                                               fa.lse_counter, save=True)
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=sdpa_mask, is_causal=causal)
            with torch.no_grad():
                o = infer()
                ms, ms_ev = self.device_ms(infer, "flash_fwd"), cuda_ms(infer, reps=20)
                lse_ms, lse_ev = self.device_ms(save, "flash_fwd"), cuda_ms(save, reps=20)
                plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v, mask, causal),
                                   reps=3, warmup=1)
                sdpa_ms, sdpa_ev = self.device_ms(sdpa), cuda_ms(sdpa, reps=20)
            flops = 2.0 * attention_pairs(b, h, t_q, t_k, mask, causal) * (d + d_v)
            bound_ms, bound_by = bound([q, k, v, o, bias], flops, dt)
            log(f"{fa.counter.name}: {ms:.4f} ms per launch (profiler; back-to-back CUDA events "
                f"{ms_ev:.4f}) at b={b} h={h} t_q={t_q} t_k={t_k} d={d} bf16 "
                f"mask={'yes' if masked else 'no'} causal={'yes' if causal else 'no'}; bound "
                f"{bound_ms:.4f} ms ({bound_by}, {flops / 1e9:.2f} GFLOP), "
                f"{100 * bound_ms / ms:.1f}% of it reached; saving instance {lse_ms:.4f} ms "
                f"(events {lse_ev:.4f}); plain version {plain_ms:.3f} ms; "
                f"scaled_dot_product_attention {sdpa_ms:.4f} ms (profiler; events "
                f"{sdpa_ev:.4f}), the kernel at {ms / sdpa_ms:.2f}x it")
            if main is None:
                main = ms
                self.kernels.setdefault(fa.counter.name, {}).update({
                    "name": fa.counter.name, "route": "cuda",
                    "source": "deeplearning4j_tpu_torch/ops/kernels/csrc/flash_fwd.cu",
                    "replaces": "deeplearning4j_tpu/ops/pallas/flash_attention.py:226",
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": sdpa_ms})
            if shape == FLASH_SHAPES[1]:  # masked: the saving instance as trained
                with torch.no_grad():
                    saved = save()
                lse_bound, lse_by = bound([q, k, v, bias, *saved], flops, dt)
                self.flash_lse_ms = lse_ms
                self.kernels.setdefault(fa.lse_counter.name, {}).update({
                    "name": fa.lse_counter.name, "route": "cuda",
                    "source": "deeplearning4j_tpu_torch/ops/kernels/csrc/flash_fwd.cu",
                    "replaces": "deeplearning4j_tpu/ops/pallas/flash_attention.py:226",
                    "ms": lse_ms, "plain_ms": plain_ms, "bound_ms": lse_bound,
                    "bound_by": lse_by, "library_ms": sdpa_ms})
                log(f"{fa.lse_counter.name}: {lse_ms:.4f} ms per launch (profiler) masked as "
                    f"trained; bound {lse_bound:.4f} ms ({lse_by}), "
                    f"{100 * lse_bound / lse_ms:.1f}% of it reached")
        if self.bert_p50_ms is not None:
            share = BERT_LAYERS * main
            log(f"bert one {BERT_B}-row request: the {BERT_LAYERS} flash launches take "
                f"{share:.3f} ms (profiler) of the {self.bert_p50_ms:.2f} ms p50 "
                f"({100 * share / self.bert_p50_ms:.1f}%)")
        if self.bert_train_step_ms is not None and self.flash_lse_ms is not None:
            share = BERT_LAYERS * self.flash_lse_ms
            log(f"bert train step: the {BERT_LAYERS} saving flash forwards take {share:.3f} ms "
                f"(profiler) of the {self.bert_train_step_ms:.2f} ms median step "
                f"({100 * share / self.bert_train_step_ms:.1f}%)")
        self.flash_bwd_times()

    def flash_bwd_times(self):
        """The backward pair's time in bf16 at BERT-base's shape with a mask
        (as trained: the features mask makes a bias) and without, at the
        long-context causal shape, and at T=16384 causal (row 9's regime):
        each kernel's own device time (``torch.profiler``) against its
        bound and the share of it reached; the pair's device time, with
        back-to-back CUDA events beside it, against the pair's bound, the
        plain backward and ``scaled_dot_product_attention``'s backward by
        device time (``autograd.grad`` through it minus its forward; a
        yardstick the port never calls); then attention's share of a BERT
        training step. The JSON rows of the two kernels carry their own
        time and bound, and the pair's plain and library times."""
        torch = self.torch
        import torch.nn.functional as F
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        dt = torch.bfloat16
        csrc = "deeplearning4j_tpu_torch/ops/kernels/csrc/flash_bwd.cu"
        pallas = "deeplearning4j_tpu/ops/pallas/flash_attention.py"
        pair_main = None
        log_clocks("flash backward times")
        for shape in (FLASH_SHAPES[1], FLASH_SHAPES[0], FLASH_SHAPES[2], FLASH_LONG_SHAPE):
            b, h, t_q, t_k, d, d_v, masked, causal = shape
            (q, k, v), mask = flash_inputs(b, h, t_q, t_k, d, d_v, dt, self.device, seed=9,
                                           mask=masked)
            bias = fa.key_bias(mask, b, t_k)
            with torch.no_grad():
                o, lse = fa.launch_flash_fwd(q, k, v, bias, causal, fa.lse_counter, save=True)
                do = torch.randn_like(o)
                run = lambda: fa.launch_flash_bwd(q, k, v, o, lse, do, bias, causal)  # noqa: E731
                grads = run()
                pair_ev = cuda_ms(run, reps=20)
                plain_ms = cuda_ms(lambda: fa.flash_attention_backward_reference(
                    q, k, v, o, lse, do, mask, causal), reps=3, warmup=1)
                per = self.pair_kernels(run, "flash backward times")
            sdpa_mask = None if mask is None else mask[:, None, None, :]
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                *leaves, attn_mask=sdpa_mask, is_causal=causal)
            sdpa_fwd = self.device_ms(sdpa)
            sdpa_bwd = self.device_ms(lambda: torch.autograd.grad(sdpa(), leaves, do)) - sdpa_fwd
            pairs = attention_pairs(b, h, t_q, t_k, mask, causal)
            delta = torch.empty(b, h, t_q, dtype=torch.float32, device=self.device)
            ins = [q, k, v, o, do, lse, bias]
            rows = {fa.bwd_dq_counter.name: (ins + [grads[0], delta], 2.0 * pairs * (2 * d + d_v),
                                             "flash_bwd_dq_kernel", f"{pallas}:633"),
                    fa.bwd_dkv_counter.name: ([q, k, v, do, lse, delta, bias, *grads[1:]],
                                              2.0 * pairs * (2 * d + 2 * d_v),
                                              "flash_bwd_dkv_kernel", f"{pallas}:655")}
            pair_bound, pair_by = bound(ins + list(grads), 2.0 * pairs * (3 * d + 2 * d_v), dt)
            tag = (f"b={b} h={h} t_q={t_q} t_k={t_k} d={d} bf16 mask={'yes' if masked else 'no'} "
                   f"causal={'yes' if causal else 'no'}")
            kernel_ms = {}
            for name, (tensors, flops, key, replaces) in rows.items():
                kms = sum(ms for k_, ms in per.items() if key in k_)
                if kms <= 0:
                    raise RuntimeError(f"the profiler saw no device time of {key} (kernels seen: "
                                       f"{sorted(per)})")
                kernel_ms[name] = kms
                kb, kby = bound(tensors, flops, dt)
                log(f"{name}: {kms:.4f} ms per launch (profiler) at {tag}; bound {kb:.4f} ms "
                    f"({kby}, {flops / 1e9:.2f} GFLOP), {100 * kb / kms:.1f}% of it reached")
                if pair_main is None:
                    self.kernels.setdefault(name, {}).update({
                        "name": name, "route": "cuda", "source": csrc,
                        "replaces": f"{replaces} (row 8); {pallas}:542, :575 (row 9, T > 8192)",
                        "ms": kms, "plain_ms": plain_ms, "bound_ms": kb, "bound_by": kby,
                        "library_ms": sdpa_bwd})
            pair_ms = sum(kernel_ms.values())
            log(f"flash backward pair: {pair_ms:.4f} ms (profiler: dq "
                f"{kernel_ms[fa.bwd_dq_counter.name]:.4f} + dk/dv "
                f"{kernel_ms[fa.bwd_dkv_counter.name]:.4f}; back-to-back CUDA events "
                f"{pair_ev:.4f}) at {tag}; bound {pair_bound:.4f} ms ({pair_by}), "
                f"{100 * pair_bound / pair_ms:.1f}% of it reached; plain backward "
                f"{plain_ms:.3f} ms; scaled_dot_product_attention backward {sdpa_bwd:.4f} ms "
                f"(profiler; forward {sdpa_fwd:.4f}), the pair at {pair_ms / sdpa_bwd:.2f}x it")
            if pair_main is None:
                pair_main = pair_ms
            del q, k, v, o, lse, do, grads, leaves
            torch.cuda.empty_cache()
        step = self.bert_train_step_ms
        if step is not None and self.flash_lse_ms is not None:
            share = BERT_LAYERS * (self.flash_lse_ms + pair_main)
            log(f"bert train step: attention (the {BERT_LAYERS} saving forwards + backward pairs, "
                f"masked; profiler) takes {share:.3f} ms of the {step:.2f} ms median step "
                f"({100 * share / step:.1f}%)")

    def dropout_times(self):
        """The dropout kernel at 8192 x 768 bf16, rate 0.1 (the ops phase's
        call): forward (``fused_dropout``, no x) and backward (the same
        kernel on gy), beside the bound, the plain version and
        ``torch.nn.functional.dropout`` (forward; its backward by
        ``autograd.grad``), a yardstick the port never calls; then the
        residual form beside ``x + F.dropout(h)``. A launch takes about as
        long as the wrapper's host time, so each call is timed after a pass
        that evicts the L2 cache (as a real caller finds its 12.6 MB input:
        cold) and the pass's own time is taken off (``cold_ms``)."""
        torch = self.torch
        import torch.nn.functional as F
        from deeplearning4j_tpu_torch.ops.kernels import fused_dropout as fd
        dt = torch.bfloat16
        g = torch.Generator().manual_seed(7)
        h, x, gy = (torch.randn(*DROPOUT_SHAPES[0], generator=g).to(dt).to(self.device)
                    for _ in range(3))
        seed, rate = 7, 0.1
        hl = h.detach().clone().requires_grad_()
        y_lib = F.dropout(hl, rate, training=True)
        library = {fd.counter.name: self.cold_ms(lambda: F.dropout(h, rate, training=True)),
                   fd.bwd_counter.name: self.cold_ms(lambda: torch.autograd.grad(
                       y_lib, [hl], gy, retain_graph=True))}
        plain_ms = cuda_ms(lambda: fd.fused_dropout_reference(None, h, seed, rate), reps=5,
                           warmup=1)
        for c, ins in ((fd.counter, h), (fd.bwd_counter, gy)):
            with torch.no_grad():
                out = fd.launch_dropout(None, ins, seed, rate, c)
                ms = self.cold_ms(lambda: fd.launch_dropout(None, ins, seed, rate, c))
                warm = cuda_ms(lambda: fd.launch_dropout(None, ins, seed, rate, c), reps=50)
            bound_ms, bound_by = bound([ins, out], 0.0, dt)
            self.kernels.setdefault(c.name, {}).update({
                "name": c.name, "route": "cuda",
                "source": "deeplearning4j_tpu_torch/ops/kernels/csrc/dropout.cu",
                "replaces": "deeplearning4j_tpu/ops/pallas/fused_dropout.py:124",
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library[c.name]})
            log(f"{c.name}: {ms:.4f} ms per launch, L2 cold ({warm:.4f} ms per call back to "
                f"back, host-bound) at {tuple(h.shape)} bf16 rate {rate}; bound {bound_ms:.4f} "
                f"ms ({bound_by}); plain version {plain_ms:.3f} ms; F.dropout"
                f"{' backward' if c is fd.bwd_counter else ''} {library[c.name]:.4f} ms")
        with torch.no_grad():
            add_ms = self.cold_ms(lambda: fd.launch_dropout(x, h, seed, rate, fd.counter))
            add_lib = self.cold_ms(lambda: x + F.dropout(h, rate, training=True))
            add_bound, _ = bound([x, h, h], 0.0, dt)
        log(f"fused_dropout_add (x + dropout(h)): {add_ms:.4f} ms per launch, L2 cold; bound "
            f"{add_bound:.4f} ms (bytes); x + F.dropout(h) {add_lib:.4f} ms")

    def conv_stats_times(self):
        """conv_stats in bf16 at each of the 15 distinct shapes of ResNet-50's
        step, by device time (its tile and column-sum kernels, profiler;
        back-to-back CUDA events beside it) beside its bound and ``torch.matmul``
        plus the two fp32 column sums by device time (a yardstick the port
        never calls); the plain version at row 13's shape; the sum over the
        step's 36 launches beside the profiler's conv_stats total in the
        step. The JSON row carries row 13's shape."""
        torch = self.torch
        from deeplearning4j_tpu_torch.ops.kernels import conv_stats as cs
        dt = torch.bfloat16
        log_clocks("conv_stats times")
        step_sum = 0.0
        for (m, k, n), launches in RESNET_CONV_SHAPES.items():
            g = torch.Generator(device=self.device).manual_seed(m + k)
            x = (torch.rand(m, k, generator=g, device=self.device) * 2.0).to(dt)
            w = (torch.randn(k, n, generator=g, device=self.device) * k ** -0.5).to(dt)
            shift = torch.randn(n, generator=g, device=self.device)

            def library():
                yf = torch.matmul(x, w).float()
                return yf.sum(0), (yf * yf).sum(0)

            with torch.no_grad():
                outs = cs.launch_conv_stats(x, w, shift)
                ms = self.device_ms(lambda: cs.launch_conv_stats(x, w, shift),
                                    match=("conv_stats", "column_sums_kernel"))
                events = cuda_ms(lambda: cs.launch_conv_stats(x, w, shift), reps=20)
                lib_ms = self.device_ms(library)
                row13 = (m, k, n) == CONV_STATS_SHAPES[0]
                if row13:
                    plain_ms = cuda_ms(lambda: cs.conv_stats_reference(x, w, shift), reps=5,
                                       warmup=1)
            flops = 2.0 * m * k * n
            bound_ms, bound_by = bound([x, w, shift, *outs], flops, dt)
            step_sum += launches * ms
            log(f"conv_stats: {ms:.4f} ms per launch at M={m} K={k} N={n} bf16 by device time "
                f"(CUDA events {events:.4f}; {flops / ms / 1e9:.1f} TFLOP/s), x{launches} a "
                f"step; bound {bound_ms:.4f} ms ({bound_by}, {flops / 1e9:.2f} GFLOP), "
                f"{100 * bound_ms / ms:.1f}% of it reached; torch.matmul + the two fp32 column "
                f"sums {lib_ms:.4f} ms by device time"
                + (f"; plain version {plain_ms:.3f} ms" if row13 else ""))
            if row13:
                self.kernels.setdefault(cs.counter.name, {}).update({
                    "name": cs.counter.name, "route": "cuda",
                    "source": "deeplearning4j_tpu_torch/ops/kernels/csrc/conv_stats.cu",
                    "replaces": "experiments/resnet_megakernel_stage4.py:64", "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": lib_ms})
            del x, w, outs
        total = sum(RESNET_CONV_SHAPES.values())
        in_step = "not measured" if self.resnet_conv_stats_ms is None else \
            f"{self.resnet_conv_stats_ms:.3f} ms"
        log(f"conv_stats over the {total} launches of a ResNet-50 step: {step_sum:.3f} ms "
            f"(each shape's device time x its launches); the profiler's conv_stats total in the "
            f"step: {in_step}")

    def cold_ms(self, fn, reps=20):
        """Milliseconds of ``fn`` with the L2 cache evicted before each call:
        CUDA events over ``reps`` of (zero a 256 MB buffer, ``fn``) less the
        same over the zeroing alone. The zeroing (~0.08 ms on an H100) also
        outlasts the wrapper's host time, so the card never waits on it."""
        torch = self.torch
        flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=self.device)
        both = cuda_ms(lambda: (flush.zero_(), fn()), reps=reps)
        alone = cuda_ms(flush.zero_, reps=reps)
        del flush
        return both - alone

    def short_times(self):
        """The short-attention kernels at BERT-base's shape (64, 12, 128, 64)
        bf16 without a mask (the ops phase's call), in both layouts: the
        forward and the backward pair by their own device time
        (``torch.profiler``; the pair's two kernels each by name) with
        back-to-back CUDA events beside it, against the bound (and the share
        of it reached), the plain versions and
        ``scaled_dot_product_attention`` on the same tensors or views by
        device time (its backward: ``autograd.grad`` minus its forward; a
        yardstick the port never calls). Then the pair alone at SHORT_LONG
        (t = 512) beside the same yardsticks."""
        torch = self.torch
        import torch.nn.functional as F
        from deeplearning4j_tpu_torch.ops.kernels import fused_attention_short as sa
        b, h, t, d = OPS_SHORT
        dt = torch.bfloat16
        log_clocks("short attention times")
        g = torch.Generator().manual_seed(9)
        bhtd = [torch.randn(b, h, t, d, generator=g).to(dt).to(self.device) for _ in range(4)]
        _, views = btd_views(bhtd, h)
        csrc = "deeplearning4j_tpu_torch/ops/kernels/csrc/short_attention.cu"
        pallas = "deeplearning4j_tpu/ops/pallas/fused_attention_short.py"
        scale = d ** -0.5
        pairs = b * h * t * t
        for btd, (q, k, v, do) in ((False, bhtd), (True, views)):
            fwd_c, bwd_c = (sa.btd_counter, sa.btd_bwd_counter) if btd else (sa.counter,
                                                                                sa.bwd_counter)
            lines = (":320", ":353") if btd else (":169", ":197")
            fwd = lambda: sa.launch_short_fwd(q, k, v, None, scale, fwd_c, btd)  # noqa: E731
            bwd = lambda: sa.launch_short_bwd(q, k, v, do, None, scale, bwd_c, btd)  # noqa: E731
            with torch.no_grad():
                o = fwd()
                grads = bwd()
                ms, ms_ev = self.device_ms(fwd, "short_fwd"), cuda_ms(fwd, reps=20)
                pair = self.pair_kernels(bwd, "short attention backward")
                bwd_ms, bwd_ev = sum(pair.values()), cuda_ms(bwd, reps=20)
                plain_ms = cuda_ms(lambda: sa.short_attention_reference(q, k, v), reps=5,
                                   warmup=1)
                plain_bwd = cuda_ms(lambda: sa.short_attention_backward_reference(q, k, v, do),
                                    reps=5, warmup=1)
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            sdpa = lambda: F.scaled_dot_product_attention(*leaves)  # noqa: E731
            sdpa_fwd = self.device_ms(sdpa)
            sdpa_bwd = self.device_ms(lambda: torch.autograd.grad(sdpa(), leaves, do)) - sdpa_fwd
            sdpa_ev = cuda_ms(sdpa, reps=20)
            for c, kms, ev, pms, lib, tensors, flops, line in (
                    (fwd_c, ms, ms_ev, plain_ms, sdpa_fwd, [q, k, v, o], 2.0 * pairs * 2 * d,
                     lines[0]),
                    (bwd_c, bwd_ms, bwd_ev, plain_bwd, sdpa_bwd, [q, k, v, do, *grads],
                     2.0 * pairs * 5 * d, lines[1])):
                kb, kby = bound(tensors, flops, dt)
                self.kernels.setdefault(c.name, {}).update({
                    "name": c.name, "route": "cuda", "source": csrc, "replaces": pallas + line,
                    "ms": kms, "plain_ms": pms, "bound_ms": kb, "bound_by": kby,
                    "library_ms": lib})
                log(f"{c.name}: {kms:.4f} ms per launch (profiler; back-to-back CUDA events "
                    f"{ev:.4f}) at b={b} h={h} t={t} d={d} bf16 "
                    f"{'(b, t, h*d) views' if btd else '(b, h, t, d)'}; bound {kb:.4f} ms "
                    f"({kby}, {flops / 1e9:.2f} GFLOP), {100 * kb / kms:.1f}% of it reached; "
                    f"plain version {pms:.3f} ms; scaled_dot_product_attention"
                    f"{' backward' if c is bwd_c else ''} {lib:.4f} ms (profiler"
                    f"{f'; events {sdpa_ev:.4f}' if c is fwd_c else ''}), the kernel at "
                    f"{kms / lib:.2f}x it")
            log(f"{bwd_c.name} kernels: " + "; ".join(f"{n[:70]} {t_:.4f} ms"
                                                      for n, t_ in sorted(pair.items())))
            del leaves, o, grads
        self.short_long_times()

    def short_long_times(self):
        """The backward pair at SHORT_LONG, bf16, unmasked, (b, h, t, d):
        each kernel's device time, the pair's against its bound, back-to-back
        CUDA events, the plain backward and SDPA's backward on the same
        tensors."""
        torch = self.torch
        import torch.nn.functional as F
        from deeplearning4j_tpu_torch.ops.kernels import fused_attention_short as sa
        b, h, t, d = SHORT_LONG
        dt = torch.bfloat16
        g = torch.Generator().manual_seed(10)
        q, k, v, do = (torch.randn(b, h, t, d, generator=g).to(dt).to(self.device)
                       for _ in range(4))
        bwd = lambda: sa.launch_short_bwd(q, k, v, do, None, d ** -0.5, sa.bwd_counter)  # noqa: E731
        with torch.no_grad():
            grads = bwd()
            pair = self.pair_kernels(bwd, "short attention backward")
            ev = cuda_ms(bwd, reps=20)
            plain = cuda_ms(lambda: sa.short_attention_backward_reference(q, k, v, do), reps=3,
                            warmup=1)
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        sdpa = lambda: F.scaled_dot_product_attention(*leaves)  # noqa: E731
        sdpa_fwd = self.device_ms(sdpa)
        sdpa_bwd = self.device_ms(lambda: torch.autograd.grad(sdpa(), leaves, do)) - sdpa_fwd
        ms = sum(pair.values())
        kb, kby = bound([q, k, v, do, *grads], 2.0 * b * h * t * t * 5 * d, dt)
        log(f"short attention backward pair: {ms:.4f} ms (profiler; back-to-back CUDA events "
            f"{ev:.4f}) at b={b} h={h} t={t} d={d} bf16 (b, h, t, d); bound {kb:.4f} ms ({kby}), "
            f"{100 * kb / ms:.1f}% of it reached; plain backward {plain:.3f} ms; "
            f"scaled_dot_product_attention backward {sdpa_bwd:.4f} ms (profiler; forward "
            f"{sdpa_fwd:.4f}), the pair at {ms / sdpa_bwd:.2f}x it; kernels: "
            + "; ".join(f"{n[:70]} {t_:.4f} ms" for n, t_ in sorted(pair.items())))
        del q, k, v, do, grads, leaves
        torch.cuda.empty_cache()

    def cudnn_ms(self, module, T, B, H, dtype):
        """``torch.nn.LSTM`` or ``torch.nn.GRU`` (cuDNN) on layer 0's work:
        the input projection from the 96-wide one-hot plus the recurrence.
        Inference, training forward, and the backward alone (on a retained
        graph). A yardstick only: the port never calls it."""
        torch = self.torch
        rnn = module(VOCAB, H).to(self.device, dtype)
        rnn.flatten_parameters()
        x = torch.randn(T, B, VOCAB, device=self.device, dtype=dtype)
        with torch.inference_mode():
            infer = cuda_ms(lambda: rnn(x), reps=10)
        xg = x.clone().requires_grad_()
        fwd = cuda_ms(lambda: rnn(xg), reps=10)
        out, _ = rnn(xg)
        dy = torch.randn_like(out)
        wrt = list(rnn.parameters()) + [xg]
        bwd = cuda_ms(lambda: torch.autograd.grad(out, wrt, dy, retain_graph=True), reps=10)
        return {"infer": infer, "fwd": fwd, "bwd": bwd}


def nvidia_smi(query="name,power.limit"):
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
            f"nvidia-smi gave nothing (exit {out.returncode})"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def log_clocks(what):
    """The SM clock now and at most, and the power drawn, beside a block of
    timings: device times of one card move with its clock."""
    log(f"{what}: nvidia-smi clocks.sm, clocks.max.sm, power.draw: "
        f"{nvidia_smi('clocks.sm,clocks.max.sm,power.draw')}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import deeplearning4j_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2
    card = nvidia_smi()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    smoke = Smoke(device)
    smoke.card = card
    t0 = time.perf_counter()
    smoke.phase("build", smoke.build)
    if smoke.failures:
        log("FAILED:", smoke.failures)
        return 1
    if sys.argv[1:] == ["--label-rules"]:
        smoke.phase("label rules", smoke.label_rules_phase)
        return 1 if smoke.failures else 0
    if sys.argv[1:] == ["--attention"]:
        smoke.phase("kernels flash", smoke.flash_checks)
        smoke.phase("kernels short attention", smoke.short_attention_checks)
        workdir = tempfile.mkdtemp(prefix=".chip_smoke-", dir=ROOT)
        try:
            smoke.phase("slice bert", lambda: smoke.bert_phase(workdir))
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        smoke.phase("train bert", smoke.bert_train_phase)
        smoke.phase("ops", smoke.ops_phase)
        smoke.phase("times flash", smoke.flash_times)
        smoke.phase("times short attention", smoke.short_times)
        log(f"total {time.perf_counter() - t0:.1f} s")
        for f in smoke.failures:
            log("FAIL " + f)
        return 1 if smoke.failures else 0
    if sys.argv[1:] == ["--recurrent"]:
        smoke.phase("kernels recurrent", smoke.recurrent_checks)
        workdir = tempfile.mkdtemp(prefix=".chip_smoke-", dir=ROOT)
        try:
            for cell in ("graves", "lstm", "gru"):
                smoke.phase(f"slice {CHAR_RNN_TAGS[cell]}",
                            lambda cell=cell: smoke.slice_phase(cell, workdir))
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        for cell in ("graves", "lstm", "gru"):
            smoke.phase(f"train {CHAR_RNN_TAGS[cell]}", lambda cell=cell: smoke.train_phase(cell))
        smoke.phase("times LSTM", smoke.lstm_times)
        smoke.phase("times GRU", smoke.gru_times)
        log(f"total {time.perf_counter() - t0:.1f} s")
        for f in smoke.failures:
            log("FAIL " + f)
        return 1 if smoke.failures else 0
    if sys.argv[1:] == ["--tf-import"]:
        smoke.phase("tf import", smoke.tf_import_phase)
        log(f"total {time.perf_counter() - t0:.1f} s")
        for f in smoke.failures:
            log("FAIL " + f)
        return 1 if smoke.failures else 0
    if sys.argv[1:] == ["--solvers"]:
        workdir = tempfile.mkdtemp(prefix=".chip_smoke-", dir=ROOT)
        try:
            smoke.phase("solvers", lambda: smoke.solvers_phase(workdir))
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"total {time.perf_counter() - t0:.1f} s")
        for f in smoke.failures:
            log("FAIL " + f)
        return 1 if smoke.failures else 0
    if sys.argv[1:] == ["--samediff"]:
        smoke.phase("train bert", smoke.bert_train_phase)
        smoke.phase("samediff bert", smoke.samediff_phase)
        log(f"total {time.perf_counter() - t0:.1f} s")
        for f in smoke.failures:
            log("FAIL " + f)
        return 1 if smoke.failures else 0
    if sys.argv[1:] == ["--lenet"]:
        workdir = tempfile.mkdtemp(prefix=".chip_smoke-", dir=ROOT)
        try:
            smoke.phase("lenet", lambda: smoke.lenet_phase(workdir))
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"total {time.perf_counter() - t0:.1f} s")
        for f in smoke.failures:
            log("FAIL " + f)
        return 1 if smoke.failures else 0
    if sys.argv[1:] == ["--runtime"]:
        workdir = tempfile.mkdtemp(prefix=".chip_smoke-", dir=ROOT)
        try:
            smoke.runtime_phase(workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"total {time.perf_counter() - t0:.1f} s")
        for f in smoke.failures:
            log("FAIL " + f)
        return 1 if smoke.failures else 0
    if sys.argv[1:] == ["--parallel"]:
        workdir = tempfile.mkdtemp(prefix=".chip_smoke-", dir=ROOT)
        try:
            smoke.parallel_phase(workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"total {time.perf_counter() - t0:.1f} s")
        for f in smoke.failures:
            log("FAIL " + f)
        return 1 if smoke.failures else 0
    if sys.argv[1:] == ["--zoo"]:
        workdir = tempfile.mkdtemp(prefix=".chip_smoke-", dir=ROOT)
        try:
            smoke.phase("kernels conv_stats", smoke.conv_stats_checks)
            smoke.phase("kernels recurrent", smoke.recurrent_checks)
            smoke.zoo_phase(workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"total {time.perf_counter() - t0:.1f} s")
        for f in smoke.failures:
            log("FAIL " + f)
        return 1 if smoke.failures else 0
    if sys.argv[1:] == ["--serving"]:
        workdir = tempfile.mkdtemp(prefix=".chip_smoke-", dir=ROOT)
        try:
            smoke.serving_phase(workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"total {time.perf_counter() - t0:.1f} s")
        for f in smoke.failures:
            log("FAIL " + f)
        return 1 if smoke.failures else 0
    if sys.argv[1:] == ["--residency"]:
        workdir = tempfile.mkdtemp(prefix=".chip_smoke-", dir=ROOT)
        try:
            smoke.residency_phase(workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"total {time.perf_counter() - t0:.1f} s")
        for f in smoke.failures:
            log("FAIL " + f)
        return 1 if smoke.failures else 0
    if sys.argv[1:] == ["--http"]:
        workdir = tempfile.mkdtemp(prefix=".chip_smoke-", dir=ROOT)
        try:
            smoke.http_phase(workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"total {time.perf_counter() - t0:.1f} s")
        for f in smoke.failures:
            log("FAIL " + f)
        return 1 if smoke.failures else 0
    if sys.argv[1:] == ["--fleet"]:
        workdir = tempfile.mkdtemp(prefix=".chip_smoke-", dir=ROOT)
        try:
            smoke.fleet_phase(workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"total {time.perf_counter() - t0:.1f} s")
        for f in smoke.failures:
            log("FAIL " + f)
        return 1 if smoke.failures else 0
    if sys.argv[1:] == ["--resnet"]:
        smoke.phase("kernels conv_stats", smoke.conv_stats_checks)
        workdir = tempfile.mkdtemp(prefix=".chip_smoke-", dir=ROOT)
        try:
            smoke.phase("resnet", lambda: smoke.resnet_phase(workdir))
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        smoke.phase("times conv_stats", smoke.conv_stats_times)
        log(f"total {time.perf_counter() - t0:.1f} s")
        for f in smoke.failures:
            log("FAIL " + f)
        return 1 if smoke.failures else 0
    smoke.phase("kernels", smoke.kernel_phase)
    workdir = tempfile.mkdtemp(prefix=".chip_smoke-", dir=ROOT)
    try:
        smoke.phase("slice graves=True", lambda: smoke.slice_phase("graves", workdir))
        smoke.phase("slice graves=False", lambda: smoke.slice_phase("lstm", workdir))
        smoke.phase("slice bert", lambda: smoke.bert_phase(workdir))
        smoke.phase("slice gru", lambda: smoke.slice_phase("gru", workdir))
        smoke.phase("train graves=True", lambda: smoke.train_phase("graves"))
        smoke.phase("train graves=False", lambda: smoke.train_phase("lstm"))
        smoke.phase("train bert", smoke.bert_train_phase)
        smoke.phase("samediff bert", smoke.samediff_phase)
        smoke.phase("tf import", smoke.tf_import_phase)
        smoke.phase("train gru", lambda: smoke.train_phase("gru"))
        smoke.phase("resnet", lambda: smoke.resnet_phase(workdir))
        smoke.phase("lenet", lambda: smoke.lenet_phase(workdir))
        smoke.phase("solvers", lambda: smoke.solvers_phase(workdir))
        smoke.runtime_phase(workdir)
        smoke.parallel_phase(workdir)
        smoke.zoo_phase(workdir)
        smoke.serving_phase(workdir)
        smoke.residency_phase(workdir)
        smoke.http_phase(workdir)
        smoke.fleet_phase(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    smoke.phase("ops", smoke.ops_phase)
    smoke.phase("times", smoke.times_phase)
    log(f"total {time.perf_counter() - t0:.1f} s")
    if smoke.failures:
        log("FAILED:")
        for f in smoke.failures:
            log("  " + f)
        return 1
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"]
    rows = [{k: r.get(k) for k in keys} for r in smoke.kernels.values()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
