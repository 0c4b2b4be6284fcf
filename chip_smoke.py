"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each of which fails the run on error (nothing is caught):

1. Build every CUDA kernel of ``pmp_vvc_tpu_torch/csrc`` with nvcc (sm_90a).
2. Hold the structural-vote kernel (K8) against its plain PyTorch version on
   the card, exactly, on 65,536 seeded maps that include rounding ties and
   every zero-count band, and on ``K8_EDGE_CASES`` (counts that leave a
   warp's second CTU empty, a view 16 bytes past a 256-byte boundary, the
   (N, 8, 8, 1) layout); time both at the prediction path's batch (512)
   and at 65,536.
3. The main path: ``predict_sequence`` on a 1920x1080, 2-frame synthetic
   sequence with the trained Luma QP22/27/32/37 and Chroma QP22 predictors
   at batch 512, then check the PartitionMat files and that K8 was launched.
4. The same port on 16 CTUs on the CPU and on the card: raw maps within
   RAW_TOL, voted QT maps equal except next to a rounding threshold.
5. One Luma ``predict`` of the main path's CTUs under torch.profiler: device
   time by kernel and the device's idle share.

6. The encode kernels K1 (reference gather), K2 (intra RMD / DM), K3 (MIP
   candidates against K2's winner), K4 (the chroma transform-quantisation,
   with and without sign-data hiding, with the single-tree LFNST region
   mask, with and without the joint Cb-Cr trial), K5 (the luma candidate
   transform-quantisation: DCT-2, DST-7/DCT-8, LFNST, transform skip; and
   with those tools off, the luma TQ of the earlier configurations), K6a
   (CCLM against the chroma DM prediction) and K7 (wave-step scatter, with
   the mode, MIP, mts_idx and lfnst_idx code grids, and the chroma steps'
   CCLM / joint Cb-Cr grid) against their plain PyTorch versions on the
   card, exactly, on seeded inputs: every CU size of both tile classes,
   luma and chroma, all 67 modes on every CU size through the chroma DM
   predictor, frame edges, CTU-top rows and partly coded neighbourhoods
   (every left/above availability pair of K6a), QP 0, 22, 37, full-swing
   residuals, residuals on which transform skip and LFNST win (every K5
   candidate kind wins somewhere), K6a's two-sample, flat and clamped
   templates, LM winning, DM winning, exact SATD ties and the CCLM gate off,
   and the joint Cb-Cr TU winning, losing and quantising to zero on odd
   residual differences of both signs; K4 with the LMCS chroma residual
   scale (K6b) for U/V and the joint TU, with and without sign-data hiding,
   its per-CU scale held to ``crs_scale_reference`` too, on a 208x120 frame
   where every CRS case occurs (``CRS_CASES``); K2 also on its tie and edge
   cases (``RMD_TIES``: a 35-way tie planar must win, modes 2 and 66
   winning with the refinement's clamp repeating them, 4xN and Nx4 CUs);
   K3 on its tie and edge cases after K2 (``MIP_TIES``: flat references on
   which every MIP candidate ties K2's planar and MIP must lose, CUs whose
   original is one candidate's prediction with t = 0 and t = 1, which must
   win, CUs on which every candidate ties below K2 and the first must win,
   every MIP size class, the padding row); K5 on its tie and edge cases
   (``K5_TIES``, at QP 4: with lam 0 DCT-2 ties transform skip at cost 0
   and must win, a zero residual ties the zero TU, the MIP gate keeps
   LFNST out, an impulse goes to transform skip, every size of the luma
   classes; with lam 2 transform skip's nonzero levels tie the zero TU,
   which must win; the padding row); K6a on its tie and edge cases in the
   16- and 32-pad chroma classes and the RDO's 4-pad one (``CCLM_TIES``:
   every CU size of the class, sides of 2 and non-square CUs whose short
   side is 4, DM equal to LM (a SATD tie DM must keep), LM better with the
   gate off, LM winning, LM clipped at 0 and at pel_max, flat,
   two-sample and neighbourless templates, the CTU top row, the frame's
   right and bottom edges, the padding row); K4 on its tie and edge cases
   in the 16- and 32-pad chroma classes and the RDO's 4-pad one
   (``K4_TIES``: the joint cost equal to the separate cost, which must
   stay; the zero TU's cost equal to the coded TU's at cost 0 and with
   levels, where the zero TU must win; a joint TU that quantises to zero;
   odd residual differences of both signs; a group's RD gain sum at its
   threshold and a gain at 3 lam; SDH moves of equal error; the CRS gate;
   the LFNST region on the joint TU; sides of 2; every CU size; the
   padding row); K1 on its edge cases in the wave path's four classes and
   the RDO's 8-pad luma and 4-pad chroma ones (``K1_EDGE_CASES``: no left,
   top or corner neighbour, none available, only the last top or the
   first bottom-left cell available, runs of order ids equal to the CU's
   and of -1, a reach past the right or bottom edge, w != h, sides of 2,
   frame 1, samples 0 and 1023, the padding row) and K7 on its own in the
   four wave classes with 0 to 4 grids (``K7_EDGE_CASES``: CUs past the
   plane's right and bottom edges, 2- and 4-wide chroma CUs at 2-sample
   offsets, 4x4 and 64x64 luma CUs, grid cells past the grid, levels at
   the int16 limits, frame 1, the padding row, a sentinel in every sample
   outside the CUs that must survive); timed at the main path's batch
   shapes, beside an empty kernel at K1's and K7's launch shapes (the
   launch floor).
7. The encode main path: 1920x1080 x 2 frames of natural content, maps
   predicted on the card by the Luma and Chroma QP22 predictors, encoded
   with the dual-tree MIP + sign-data hiding + MTS + LFNST + transform skip
   + CCLM + joint Cb-Cr + LMCS with chroma scaling + deblocking + SAO
   configuration at QP 22 through ``WavefrontEncoder.encode_frames``; the
   configuration without LMCS beside it, cold runs then one warm run each,
   old then new; stage times, wave steps, launches of every
   kernel (K4's with the chroma scale among them), the MIP, MTS, LFNST and
   transform-skip luma CUs, the LM chroma CUs and joint Cb-Cr TUs, hash SEI
   against an MD5 of the returned recon, luma PSNR.
8. The same kernels against their plain versions on the real schedule rows
   of the main path's first 48 wave steps and of its first 16 with chroma
   rows.
9. The bench's configuration (``bench.py:186-197`` without the device RDO:
   the main path's tools plus ALF, its chroma filter and CC-ALF, at QP 32)
   at 416x240 x 2 frames of natural content, with the QP 22 maps, cold then
   warm, with the stage times (``alf`` among them); hash SEI, and the CTUs
   with each ALF and CC-ALF filter on (luma ALF must be on somewhere).
10. Frames encoded with ``device="cpu"`` (plain versions) and on the card
    in seven configurations: no tools at 208x120; MIP and SDH, and MIP, SDH,
    MTS, LFNST and transform skip, at 416x240 on natural content; those plus
    CCLM and joint Cb-Cr at 416x240 in dual tree and at 208x120 in single
    tree, on content where LM and the joint Cb-Cr trial win (both must
    fire); the bench's tools at 416x240 in dual tree on natural content and
    at 208x120 in single tree on that chroma content (VPDUs cut by both
    frame edges). The bitstreams must be byte-identical.
11. One warm frame's wave scan under torch.profiler: device time by kernel
    and the device's idle share.

The device RDO (K9: K9a ``rdo_luma_select``, K9b ``rdo_chroma_select``,
K9c ``rdo_leaf_cost`` in ``csrc/rdo_leaf.cu``), its phases run beside the
ones above:

12. K9a/K9b/K9c, and K1, K4, K5 and K6a as the RDO calls them, against their
    plain versions on the card, exactly, on rects of every tile class
    (``RDO_CASES``: at the frame's top-left and bottom-right corners, chroma
    sides of 2, the 64 class, LM winning and losing, two QP points in one
    call, SSEs above 2^24, 2x2 chroma TUs), and the whole
    ``luma_leaf_costs`` / ``chroma_leaf_costs`` against the CPU's; K9a on
    its tie and edge cases at every pad class (``K9A_TIES``: flat rects on
    flat references, where planar must win a 35-way tie; originals that are
    mode 2's, mode 66's or another even angular's prediction, which must
    win at cost 0; modes 2 and 66 tied at the least cost, where 2 must win;
    4x4, 4x8, 8x4 and 8x8 rects; rects at x = 0, y = 0 and on the frame's
    right and bottom edges; the padding row); K9b on its own
    (``K9B_TIES``: flat references and originals, where planar must win a
    4-way tie; originals that are DC's (on non-square rects too), HOR's or
    VER's prediction; a symmetric rect where HOR and VER tie at the least
    joint cost and HOR must win; a rect whose U alone takes HOR but whose
    joint sum takes VER; chroma sides of 2, 32x32 chroma rects, the
    frame's edges, the padding row); K9c on its edge cases
    (``K9C_EDGE_CASES``: both trees at 1 and 4 QP points in every class,
    SSEs above 2^24, levels at +-32,767 and -32,768, garbage recon beyond
    the rects, the frame's edges, chroma sides of 2, padding rows; K4's and
    K5's levels checked zero beyond each rect, which K9c relies on); each
    kernel timed on one 16,384-rect chunk of the 8-pad class, K9a also on
    one full chunk of each other class (8,192, 2,048 and 512 rects), K9b's
    and K9c's bounds at every class's chunk.
13. The RDO's main path: the 1080p x 2 encode of phase 7's configuration at
    accel level 0 with ``rdo_fallback`` (every MTT node deferred to the
    search, QT splits below the map's banned), cold (the node DAGs built)
    then warm with every kernel's launches counted (K9a's, K9b's and K9c's
    per pad class too); stage times with the RDO's (geometry, leaf costs
    with their device span, DP), deferred nodes, CUs per size against
    phase 7's L3 run, hash SEI.
14. The bench's configuration (``bench.py:186-197`` as it is, with
    ``rdo_fallback``) at 416x240 x 2: its maps cover 384x192 only, and at L3
    K9 decides the nodes outside them and no others; on the frames cut to
    384x192, K9 launches 0 times at L3 and the stream equals the one without
    the fallback; L0, L1, L2 launch K9 where nodes defer and the four levels
    give at least three distinct streams; ``encode_frame(rdo=True)`` on one
    frame.
15. The label search: ``search_frames`` / ``search_frames_chroma`` with four
    encoders (QP 22/27/32/37) on 2 frames of 512x512 natural content, equal
    to four single-QP searches, timed, K9's launches per pad class logged.
16. CPU against card: 128x128 at L1 with the MTT maps of the JAX package's
    accel-level test (dual tree) and ``encode_frame(rdo=True)`` at 208x120
    (single tree), both with the bench's tools: byte-identical streams.

Training (K11a ``qbd_loss`` in ``csrc/qbd_loss.cu``, K11b ``adam_update``
in ``csrc/adam.cu``):

17. K11a in modes q, bd and qbd, with the luma and chroma weight matrices,
    at QP 22 (w0 = 1), 27 and 37, at batch 32 and 7, on outputs that meet
    their labels exactly at a quarter of the positions, against its plain
    version (the autograd of ``train/losses.py``) on the card: the loss
    within 1e-6 relative, each gradient within 2 ulps of its largest
    element, two runs bit-equal; the same on ``K11A_EDGE_CASES`` (branch
    outputs as views off the 16-byte grain, one block, two calls back to
    back that must be bit-equal with the ticket counter back at 0); K11b on
    the luma Q + BD pair's 92 tensors at counts 1 and 1,000 and with zero
    gradients, exactly; both timed at the training path's shapes, K11b
    beside ``torch.optim.Adam(fused=True)``; K11a's launch beside
    ``_QBDLoss.backward``'s scalings under torch.profiler.
18. The training path: ``tools/gen_dataset.py`` labels 512x512 natural
    content with the device RDO (4 frames to train on, 1 to validate; luma
    QP 22/27/32/37, chroma QP 22), ``tools/train_bd.py`` trains the bd and
    qbd stages of Luma and Chroma QP 22 at batch 32 (every loss must fall,
    K11a and K11b launch once per step), the checkpoints reload through
    ``CompPredictor.from_trained`` and predict a frame through K8; warm
    steps/s and CTU samples/s per stage; one warm joint step's device time
    split between the nets' forward, K11a, the backward and K11b, and by
    kernel class under torch.profiler with the idle share.

The sequential ``FrameEncoder`` (K10a ``predict_block`` in
``csrc/seq_intra.cu``, K10b ``predict_mip_all`` in ``csrc/seq_mip.cu``, K10c
``seq_tq`` in ``csrc/seq_tq.cu``, K10d ``satd`` in ``csrc/seq_satd.cu``;
K10e ``sad`` / ``sse`` in ``csrc/seq_dist.cu``, which no path calls) and
the encode CLI:

19. K10a-e against their plain versions on the card, exactly: K10a on all
    67 modes at every luma size 4-64 and chroma size 2-32 at 8 and 10 bits,
    K10b at every size class, K10c on every MTS pair, DCT-2 at 64 and the
    ISP shapes at QP 0/22/37/51 with every stage mask, K10d on every tile
    shape, K10e at every side 2-64 against one original and one per block,
    on a block whose int32 SSE wraps, on differences at the int32 limits
    and, for its scalar instantiation, on views off the 16-byte grain and
    3x5 blocks (``K10E_EDGE_CASES``); K10c on its edge cases
    (``K10C_EDGE_CASES``: full-scale +-(2^bd - 1) residual patterns at
    every shape of ``SEQ_TQ_SHAPES`` and
    every kind at 8 and 10 bits, levels at the 16-bit limits through both
    inverse clips, dequantiser shifts of 0, -9, -10 and -11 (the least at 10
    bits, a 1x1 TU) with products past 2^31 that wrap in int32, coefficients
    on the dead zone's boundaries, negative sums at a rounding half, the
    zero-out at 64 and at 32) and K10d on its own (``K10D_EDGE_CASES``: differences of
    +-1023 at every tile shape, DC-only tiles, non-square tile sums that
    float32 rounds onto or next to an integer, one original for all
    candidates and one each), K10a on its own (``K10A_EDGE_CASES``: rows of
    0 and the peak in turns and in runs of two, whose 4-tap sums pass the
    range, flat rows, the wide angles of 4x64, 64x4 and 2x32, the side
    projection at its clamp, the angular and the planar / DC PDPC, DC of
    non-square CUs, sides of 2, 64x64, a single mode, repeated modes and
    modes out of order, U and V in one call, 8 bits) and K10b on its own
    (``K10B_EDGE_CASES``: every size class, upsampling by 16 both ways, a
    negative first boundary term, reduced samples clipped at 0 and at the
    peak, 8 bits), K10a's and K10b's rows at odd offsets of one upload as
    the encoder passes them, each case reached; K10c's and K10d's wrappers
    refusing inputs off the 16-byte grain; each timed at 16x16 (a CUDA
    graph of 50 calls) beside its plain version and the wrapper's round trip
    from numpy to numpy.
20. The sequential path: ``FrameEncoder(mode_select="satd")`` with all 67
    RMD modes on one 416x240 frame of natural content (two until phases
    29-31 joined), the bench's tools without sign-data hiding and with MRL,
    ISP and dependent quantization, dual tree, the QP 22 maps; a cold run,
    then a warm one with every K10 kernel's launches counted, K10a's by (w, h, modes,
    luma, blocks: a chroma CU's U and V are one call), K10b's by (w, h),
    K10c's by (stage mask, w, h, kinds) and K10d's by (w, h, candidates)
    (``seq_call_mix``), every entry of the four mixes timed with its bound
    and the kernels' lost time over each mix (``seq_mix_times``); frames/s,
    stage times,
    the MRL and ISP CUs and dependent-quantization TUs (each must occur),
    hash SEI and luma PSNR; one more frame under torch.profiler and
    cProfile (device idle share, the host's costliest functions).
21. The same configuration at 208x120 with ``device="cpu"`` and on the
    card: byte-identical.
22. ``cli.encode.main`` on a 2-frame 8-bit 256x128 YUV with the QP 22
    predictors' maps, ``--engine sequential`` and ``--engine wavefront``,
    on the card: each frame's hash SEI equals its recon's MD5;
    ``cli.decode.main`` on the sequential stream, on the card, writes the
    encode's recon file with every hash verified.

Phases 29-31 (the sequential RDO split search and the decoder) are listed
after phase 28: 29 and 30 run in worker processes beside phases 10, 16,
21 and 22, 31 right after phase 22.

Multi-device encoding (K12a, the CU-batch-sharded wave scan: K1-K7 on each
rank's block of a step and one all-gather per pass; K12b, the spatial-stripe
scan's halo pack and unpack in ``csrc/halo.cu``), over torch.distributed:

23. K12b against its plain version on the card, exactly, on seeded planes
    at every rank of meshes of 1, 2 and 4 stripes (both edges, the interior
    ranks) at the spatial paths' shapes, and on ``K12B_EDGE_CASES`` (the
    scalar instantiation at strd 130 and on planes off the 16-byte grain, H
    2, every (has_left, has_right) pair, quads by division); both kernels
    timed per step (a CUDA graph of 50 calls) at the two-rank path's rank
    0, with their byte bound.
24. ``multidevice-nccl1``: a one-rank NCCL group (``file://`` store in a
    temp dir). The bench's configuration exactly (``bench.py:186-197``, L3
    with ``rdo_fallback``) at 416x240 x 2 with the QP 22 maps under the mesh
    and without it, cold then warm: byte-identical streams and equal K1-K7
    launches; the one-stripe spatial encode at 256x128 with the JAX
    package's spatial tools, equal to the meshless stream, K12b's pack
    launched every step and its unpack (no neighbour) never;
    the all-gather of a 32-pad luma class-step and the (neighbourless)
    exchange timed; the group torn down.
25. ``multidevice-2rank``: two children (``chip_smoke.py --md-rank R DIR``)
    on cuda:0 under gloo, tensors staged through host memory (NCCL does not
    run two ranks on one GPU): the bench's configuration under the mesh,
    both ranks' streams equal to phase 24's single-process stream; the
    512x256 spatial encode over two stripes, equal to the meshless card
    stream; every K1-K7 kernel and K12b launched on each rank; the
    all-gather and the halo exchange timed. A child that fails, or outlives
    CHILD_TIMEOUT, fails the run.

The data-parallel CNN (K12c: the gradient bucket ``bucket_pack`` in
``csrc/grad_bucket.cu``, the batch-sharded predictor, the data-parallel
training step, ``entry`` and ``dryrun_multichip``):

26. ``dp-kernels``: K12c against its plain version on the card, exactly, on
    the luma and the chroma Q + BD pairs' gradient shapes at scales 1 and
    1/2 and on 300 tensors (three launches); timed per call (a CUDA graph
    of 50) on each pair with its byte bound and the share of it reached.
27. ``dp-nccl1``: a one-rank NCCL group. The luma QP 22 predictor on the
    1920x1080 x 2 CTUs under the mesh, bit-equal to the meshless one; 5
    joint luma steps at batch 32 (committed QP 22 nets, seeded float
    samples) whose losses and parameters equal the meshless run's bit for
    bit under cuDNN's deterministic algorithms (its default backward sums in
    a run-dependent order), with K8 / K11a / K11b / K12c launches; ``entry()`` and
    ``dryrun_multichip`` on the mesh; warm CTU predictions/s and steps/s
    beside the meshless ones; the all-reduce of the bucket per step.
28. ``dp-2rank``: two children (``chip_smoke.py --dp-rank R DIR``) on
    cuda:0 under gloo with host staging: the predictor (raw bt / dire
    within RAW_TOL of the single-process card run, whose chunks are twice
    a rank's block, voted QT equal where the raw maps keep RAW_TOL from a
    threshold); 3 joint steps whose parameters are
    bit-equal on both ranks and within the CPU tests' bounds of the
    single-process card run; ``dryrun_multichip``; the all-reduce via host.

The sequential encoder's RDO split search (``FrameEncoder._rd_search``,
host Python over K10a-d in its trials) and the decoder
(``codec/decoder.py``, K10a-c: predictions, MIP, a TU's dequantisation and
inverse transform in one K10c launch); 29 and 30 run in three spawned
worker processes (``rdo=True``, maps-rd-fb, 30's four runs in turn) while
phases 10, 16, 21 and 22 run, and 31 after phase 22:

29. ``seq-rdo``: ``natural_frame(192, 128, seed=21)`` at QP 32 in
    ``tools/rdcheck.py:ctc_cfg``'s configuration (``ctc_cfg``: dual tree,
    MTS, LFNST, MIP, MRL, ISP, CCLM, joint Cb-Cr, dependent quantization,
    LMCS with chroma scaling, SAO, ALF, CC-ALF, deblocking, the CTC chroma
    QP table) with ``mode_select="rd"`` over every fourth RMD mode (the
    phase's one cut), on the card: ``encode_frame(rdo=True)``, then the QP
    22 predictors' maps with ``rdo_fallback`` at accel level 0; each with
    its host seconds and ``code`` time, K10a-d's launches (each must
    launch) and call mix, the deferred nodes and their winning splits, bits,
    luma PSNR and the hash SEI against the recon's MD5. At rdcheck's L3,
    and at L2 and L1, those maps defer no node of this frame, so the
    fallback runs at L0.
30. ``seq-rdo-cpu-vs-card``: ``encode_frame(rdo=True)`` and the QP 22 maps
    with ``rdo_fallback`` at accel level 0 on a 64x64 frame of phase 29's
    configuration (``mode_select="satd"``), with ``device="cpu"`` and on
    the card: byte-identical streams.
31. ``seq-decode``: the port's ``decode_stream(verify_hash=True)`` on the
    card on the streams of phases 20, 21, 22 (both engines), 29, 30 and 9
    (the wave path's bench configuration): every hash verified, every recon the
    encoder's; each decode's time per frame, K10a-c's launches and call mix
    (K10d none; K10c's DEQUANT | INV entries must occur) and the coded
    tree's split decisions.

``python3 chip_smoke.py --seq-only`` runs the build and phases 19-22 and
29-31 alone (phase 31 without phase 9's stream),
``--md-only`` the build and phases 23-28, ``--k2-times PARENT`` the build,
phases 6 and 19 and K2's time beside the parent commit's K2 (``PARENT``:
a directory holding that commit's ``pmp_vvc_tpu_torch/csrc``, e.g. from
``git archive``) and beside this K2 built in the other shapes of
``K2_VARIANTS``, in turns in one process (``phase_variant_times``);
``--k3-times PARENT`` the same for K3 (``K3_VARIANTS``, the luma classes);
``--k5-times PARENT`` the same for K5 (``K5_VARIANTS``, ``k5_cases``: the
luma classes, the tools off, the RDO's 8-pad chunk); ``--k6a-times
PARENT`` the same for K6a (``K6A_VARIANTS``, ``k6a_cases``: the chroma
classes, the RDO's 4-pad chunk of 16,384 rects, 16 CUs of 2x2 and of 32x32
chroma samples), with phase 12's checks and times; ``--k4-times PARENT``
the same for K4 (``K4_VARIANTS``, ``k4_cases``: the chroma classes with and
without the chroma residual scale, without the trial, the RDO's 4-pad
chunk, the two probes), with phase 12's checks and times; ``--k1-times
PARENT`` the same for K1 (``K1_VARIANTS``, ``k1_cases``: the four classes,
the two probes, the RDO's 8-pad luma and 4-pad chroma chunks of 16,384
rects), with phase 12's checks and times; ``--k7-times PARENT`` the same
for K7 (``K7_VARIANTS``, the four classes with the main path's grids, the
two probes); ``--k9a-times PARENT`` the same for K9a (``K9A_VARIANTS``,
``k9a_cases``: one full RDO chunk of each pad class, 16 rects of 4x4 and of
32x32; every build also held to the plain version on ``K9A_TIES``), with
phase 12's checks and times, then phase 13's L0 encode warm with the
parent's K9 library and this one in turns (``rdo_leaf_device`` of each,
equal streams); ``--k9b-times PARENT`` the same for K9b (``K9B_VARIANTS``,
``k9b_cases``: one full chunk of each pad class's chroma tree, 16 rects of
4x4 and of 32x32 chroma samples; every build also held to ``K9B_TIES``)
and ``--k9c-times PARENT`` for K9c (``K9C_VARIANTS``, ``k9c_cases``: one
full chunk of each class in both trees at 1 and at 4 QP points; every
build held to ``K9C_EDGE_CASES``), each with phase 12's checks and times
and the L0 pair; ``--k10a-times PARENT`` the same for K10a
(``K10A_VARIANTS``, ``k10a_cases``: 67 modes at 4x4, 16x16, 32x32 and 64x64
luma, a chroma CU's U and V in one call at 4x4 and 16x16, planar alone at
16x16; every build also held to ``K10A_EDGE_CASES``) and ``--k10b-times
PARENT`` for K10b (``K10B_VARIANTS``, ``k10b_cases``: 4x4, 8x8, 16x16,
4x64, 64x64; every build held to ``K10B_EDGE_CASES``); ``--k10c-times
PARENT`` the same for K10c (``K10C_VARIANTS``,
``k10c_cases``: the 16x16 round trip at QP 37, the forward and the inverse
transform alone at 32x16, 32x32 and 16x16, a 64x64 and a 1x16 round trip,
16 TUs of 8x8; every build also held to the plain version on
``K10C_EDGE_CASES``) and ``--k10d-times PARENT`` for K10d
(``K10D_VARIANTS``, ``k10d_cases``: 67 candidates at 16x16, 32x16, 32x32
and 64x64, 12 at 32x16, 67 of 4x4, 8 of 2x8, 8 of 16x16 with an original
each; every build held to ``K10D_EDGE_CASES``), with phase 19's checks and
times, then phase 20's encode (both frames cold, counting the call mix,
then the first warm with the parent's kernel and this one in turns:
``code`` time and wall of each, equal streams) and the kernel's mix timed
with both builds (``phase_k10_seq``; K10a's also counts the launches its
stacked chroma call saves); each of them ends
with the launch floor (K9a-c's and K10a-d's before their path pairs);
``--k11a-times PARENT`` the same for K11a (``K11A_VARIANTS``,
``k11a_cases``: mode qbd luma at batch 32 and 64, bd chroma at QP 37 and q
at batch 64, qbd at batch 7 and 257; every build held to
``K11A_EDGE_CASES``), with phase 17's checks and times, then the luma joint
training step with the parent's K11a and this one in turns (steps/s of
each, equal losses and parameters; ``phase_k11a_train``); ``--k12b-times
PARENT`` for K12b (``K12B_VARIANTS``, ``k12b_cases``: the pack and the
unpack at 512x256 over 2 stripes at ranks 0 and 1, over 4 at an interior
rank, 3840x2160 over 2, 1920x1080 over 3 at the interior rank, the pack of
256x128 on one stripe; every build held to ``K12B_EDGE_CASES``), with phase
23's checks and times; ``--k8-times PARENT`` for K8 (``K8_VARIANTS``,
``k8_cases``: N = 512 and 508, the prediction path's chunks, 8, 65,536
and 524,288; every build held to ``K8_EDGE_CASES``), with phase 2's checks
and times; ``--k10e-times PARENT`` for K10e (``K10E_VARIANTS``, ``k10e_cases``: ``sad``
and ``sse`` on 67 blocks of 16x16 and of 4x4 against one original, on 16
of 32x32 and 8 of 64x64 with an original each; every build held to
``K10E_EDGE_CASES``), with phase 19's checks and times (``torch.cdist``'s
time for ``sad`` among them); K8's, K10e's, K11a's and K12b's cases log
the share of their bounds; all end with the launch floor; none prints a
result line.

Prints the kernels' numbers as one JSON line (K12b's and K12c's rows among
them; under "k12a" the sharded scan's K1-K7 launches and collective times
per transport, under "k12c" the data-parallel rates and the all-reduce per
transport), the card's name and power limit, and last ``{"ok": true,
"device": {...}}``. Exits non-zero without CUDA.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import inspect
import itertools
import json
import pathlib
import pickle
import subprocess
import sys
import tempfile
import time
import types
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

from pmp_vvc_tpu_torch import _build
from pmp_vvc_tpu_torch.cli import decode as cli_decode
from pmp_vvc_tpu_torch.cli import encode as cli_encode
from pmp_vvc_tpu_torch.codec import rdo_device as trd
from pmp_vvc_tpu_torch.codec import decoder as seq_dec
from pmp_vvc_tpu_torch.codec import encoder as seq_enc
from pmp_vvc_tpu_torch.codec import wavefront as wf
from pmp_vvc_tpu_torch.codec.encoder import FrameEncoder
from pmp_vvc_tpu_torch.codec.rdo_device import DeviceRDO
from pmp_vvc_tpu_torch.codec.headers import VVCConfig
from pmp_vvc_tpu_torch.data.synthcontent import natural_frame, natural_sequence
from pmp_vvc_tpu_torch.data.yuv import blocks_for_sequence, write_yuv420
from pmp_vvc_tpu_torch.ops import distortion as dist_ops
from pmp_vvc_tpu_torch.ops import intra_generic as ig
from pmp_vvc_tpu_torch.ops import intra as intra_ops
from pmp_vvc_tpu_torch.ops import mip as mip_ops
from pmp_vvc_tpu_torch.ops import quant as quant_ops
from pmp_vvc_tpu_torch.ops import rdo_generic as rg
from pmp_vvc_tpu_torch.ops import tq_generic as ttq
from pmp_vvc_tpu_torch.ops.cclm_generic import (
    cclm_costs, cclm_models, cclm_neighbours, cclm_select, cclm_select_reference)
from pmp_vvc_tpu_torch.ops.intra_generic import (
    gather_plane, intra_rmd, intra_rmd_reference, predict_generic, ref_gather,
    ref_gather_reference)
from pmp_vvc_tpu_torch.ops.lmcs_generic import (
    UNIT_SCALE, crs_forward, crs_lut, crs_neighbours, crs_scale_reference)
from pmp_vvc_tpu_torch.ops import cclm_generic as cclm_g
from pmp_vvc_tpu_torch.ops import mip_generic as mip_g
from pmp_vvc_tpu_torch.ops.mip_generic import (
    mip_select, mip_select_reference, predict_mip_generic)
from pmp_vvc_tpu_torch.ops.rows import unpack_rows
from pmp_vvc_tpu_torch.ops.sdh_generic import _cg_tables, apply_sdh_generic, sdh_moves
from pmp_vvc_tpu_torch.ops.lfnst_generic import inv_lfnst_generic
from pmp_vvc_tpu_torch.ops.tq_generic import (
    tq, tq_mts, tq_mts_candidates, tq_mts_reference, tq_reference)
from pmp_vvc_tpu_torch.ops import transforms as tr_ops
from pmp_vvc_tpu_torch.ops.transforms import DCT2, DCT8, DST7
from pmp_vvc_tpu_torch import parallel as md
from pmp_vvc_tpu_torch.parallel import comm
from pmp_vvc_tpu_torch.parallel import spatial as sp
from pmp_vvc_tpu_torch.parallel.dryrun import spatial_encode
from pmp_vvc_tpu_torch.pmp.map2partition import blocks_to_frame_partition
from pmp_vvc_tpu_torch.pmp.pipeline import predict_sequence
from pmp_vvc_tpu_torch.pmp.predict import CompPredictor
from pmp_vvc_tpu_torch.pmp import structural as vote_mod
from pmp_vvc_tpu_torch.pmp.structural import (
    structural_vote, structural_vote_reference)
from pmp_vvc_tpu_torch.models import (ChromaMSBDNet, ChromaQNet, LumaMSBDNet, LumaQNet,
                                      init_params)
from pmp_vvc_tpu_torch.ops import train_generic as tg
from pmp_vvc_tpu_torch.tools import gen_dataset, train_bd
from pmp_vvc_tpu_torch.train.driver import load_npy_split
from pmp_vvc_tpu_torch.train.trainer import (Adam, make_bd_train_step, make_qbd_train_step,
                                             shard_batch)
from pmp_vvc_tpu_torch.entry import dryrun_multichip, entry
from pmp_vvc_tpu_torch.models import load_trained, params_from_jax
from pmp_vvc_tpu_torch.ops import dp_generic as dp_ops

REPO = pathlib.Path(__file__).resolve().parent
CKPT = REPO / "trained_models" / "bd"
W, H, FRAMES = 1920, 1080, 2          # JVET CTC class-B geometry
PREDICTORS = (("Luma", 22), ("Luma", 27), ("Luma", 32), ("Luma", 37),
              ("Chroma", 22))
BATCH = 512
VOTE_N = 65_536
HBM_BYTES_PER_S = 3.35e12             # H100 SXM, data sheet
FP32_OPS_PER_S = 67e12                # H100 SXM float32 outside tensor cores
# 32-bit integer add, multiply-add, compare and shift: 64 results per clock
# per SM (CUDA C++ Programming Guide, arithmetic instruction throughput,
# compute capability 9.0); times the SMs and the max SM clock, int32_ops_per_s
INT32_PER_CLOCK_PER_SM = 64
# The kernels whose counted operations are all integer, from their sources:
# K1 (reference substitution and filter), K2 and K9a (angular prediction,
# Hadamard SATD), K3 (MIP), K6a (CCLM fit and SATDs), K9b (SATDs) and K10a-e
# (prediction, MIP, the integer transform and quantiser, SATD, SAD / SSE).
# K9c mixes int32 sums with float32 rate-distortion costs, and K8 and K11
# are float32: they keep FP32_OPS_PER_S, which bounds any mix from below.
# K4 and K5 count their integer and float operations apart, each against
# its own rate (``kernel_bounds``). A multiply-add counts once
# against the int32 rate, which counts one result per multiply-add.
INT32_KERNELS = frozenset({"ref_gather", "intra_rmd", "mip_rmd", "cclm", "rdo_luma_select",
                           "rdo_chroma_select", "seq_intra", "seq_mip", "seq_tq", "seq_satd",
                           "seq_sad", "seq_sse"})
# Card against CPU, both float32 with TF32 off. The convolutions sum up to
# 1,600 terms in another order on each side, and cuDNN may pick Winograd or
# FFT algorithms whose float32 error exceeds a direct sum's. The CPU port
# agrees with the JAX nets within 1e-4 (tests/test_torch_models.py); 1e-3 on
# outputs of size ~1 allows for the card's algorithms with a margin.
RAW_TOL = 1e-3

# Scalar float32 operations of the K8 kernel per CTU, counted from
# csrc/structural_vote.cu: 48 max + 16 round + 32 clamp + 16 zero tests for
# every map; case A (num0 <= 12) adds 16 promotions + 4 x (4 adds + 4 tests
# + 2 range tests + 4 selects); case B (12 < num0 < 16) adds 16 stores.
OPS_COMMON, OPS_CASE_A, OPS_CASE_B = 112, 72, 16


@functools.cache
def int32_ops_per_s() -> float:
    """The card's 32-bit integer rate: INT32_PER_CLOCK_PER_SM times its SMs
    times its max SM clock as nvidia-smi reports it."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    mhz = float(smi.stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_PER_CLOCK_PER_SM * sms * mhz * 1e6


def ops_rate(name: str) -> float:
    """Operations per second that bound kernel ``name``'s counted operations."""
    return int32_ops_per_s() if name in INT32_KERNELS else FP32_OPS_PER_S


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's line (``[phase] ...``) after the seconds
    since the script started."""
    if msg.startswith("["):
        msg = f"{time.perf_counter() - _T0:7.1f} s {msg}"
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def vote_inputs(n: int, seed: int = 0) -> np.ndarray:
    """(n, 8, 8) float32 raw QT maps covering the vote's cases.

    Every 2x2 pattern of one quadrant in each quadrant position, maps with
    each zero count 0..16, exact k+0.5 ties, all-zero maps, then random fill.
    """
    rng = np.random.RandomState(seed)
    pat = np.array(list(itertools.product(range(4), repeat=4))).reshape(-1, 2, 2)
    quads = rng.randint(0, 4, (4, len(pat), 4, 4))
    for q in range(4):
        r, c = 2 * (q >> 1), 2 * (q & 1)
        quads[q, :, r:r + 2, c:c + 2] = pat
    bands = rng.randint(1, 4, (17, 64, 16))
    for k in range(17):
        for m in bands[k]:
            m[rng.permutation(16)[:k]] = 0
    targets = np.concatenate([quads.reshape(-1, 4, 4),
                              bands.reshape(-1, 4, 4)]).astype(np.float64)
    # raw values whose 2x2 max rounds (and clamps) to the target pooled value
    up = targets.repeat(2, axis=1).repeat(2, axis=2)
    raw = up + rng.uniform(-0.45, 0.45, up.shape)
    raw = np.where(up == 0, rng.uniform(-3.0, 0.45, up.shape), raw)
    raw = np.where(up == 3, rng.uniform(2.55, 6.0, up.shape), raw)
    ties = rng.choice([-1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 0.0, 1.0, 2.0, 3.0],
                      (512, 8, 8))
    zeros = np.zeros((64, 8, 8))
    fill = rng.randn(max(0, n - len(raw) - len(ties) - len(zeros)), 8, 8) * 1.5 + 1.0
    return np.concatenate([raw, ties, zeros, fill])[:n].astype(np.float32)


def vote_ops(x: torch.Tensor) -> int:
    """Scalar operations the K8 kernel does on these maps (data-dependent)."""
    pooled = x.reshape(-1, 4, 2, 4, 2).amax(dim=(2, 4)).round().clamp(0, 3)
    num0 = (pooled == 0).sum(dim=(1, 2))
    case_a = int((num0 <= 12).sum())
    case_b = int(((num0 > 12) & (num0 < 16)).sum())
    return OPS_COMMON * x.shape[0] + OPS_CASE_A * case_a + OPS_CASE_B * case_b


def _events_ms(run, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(fn, iters: int) -> float:
    """Time per call of ``fn`` called back to back from Python (CUDA events).

    At small sizes this is the host's dispatch time, not the device's.
    """
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    return _events_ms(fn, iters)


def graph_ms(fn, reps: int = 50, iters: int = 20) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed, so that no host dispatch sits between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, iters) / reps


def ptxas_lines(out: str) -> list:
    """ptxas's -v lines that name a kernel or give its registers, stack
    frame and spills."""
    return [line.strip() for line in out.splitlines()
            if "Function properties" in line or "registers" in line or "spill" in line]


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(logs)} kernel(s) in {time.perf_counter() - t0:.2f} s")
    for name, out in logs.items():
        for line in ptxas_lines(out):
            log(f"[build] {name}: {line}")


def vote_bound(x: torch.Tensor) -> tuple[float, str, int, int]:
    """(bound ms, bound_by, bytes, ops) of one K8 call on the maps ``x``:
    each map read and written once, ``vote_ops`` at the float32 rate."""
    nbytes, ops = 2 * x.numel() * 4, vote_ops(x)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


# K8's untimed edge cases, held exactly to the plain version on every build:
# counts that leave a warp's second CTU empty, a view 16-byte aligned but not
# 256-byte aligned, and the trailing channel layout
K8_EDGE_CASES = ("N 1", "N 2", "N 3", "N 31", "N 33", "N 507",
                 "N 33 as a view 4 floats into a buffer", "N 33 as (N, 8, 8, 1)")


def k8_edge_calls() -> list:
    """``K8_EDGE_CASES`` as (call, plain outputs) pairs."""
    maps = torch.from_numpy(vote_inputs(4096, seed=6)).to(DEVICE)
    spread = lambda n: maps[torch.linspace(0, len(maps) - 1, n).long()]  # noqa: E731
    xs = [spread(n) for n in (1, 2, 3, 31, 33, 507)]
    buf = torch.zeros(33 * 64 + 4, device=DEVICE)
    buf[4:] = spread(33).flatten()
    xs.append(buf[4:].view(33, 8, 8))
    xs.append(spread(33)[..., None].contiguous())
    check(xs[-2].data_ptr() % 16 == 0 and xs[-2].data_ptr() % 256 == 16,
          "K8's view edge case is not 16 bytes past a 256-byte boundary")
    return [((lambda x=x: structural_vote(x)), structural_vote_reference(x)) for x in xs]


def k8_edge_variant_checks() -> list:
    """``K8_EDGE_CASES`` as one ``VARIANT_CHECKS`` entry."""
    def make():
        calls = k8_edge_calls()
        return (lambda: [call() for call, _ in calls]), [want for _, want in calls]
    return [("K8_EDGE_CASES", make)]


def phase_vote() -> dict:
    x = torch.from_numpy(vote_inputs(VOTE_N, seed=0)).cuda()
    got = structural_vote(x)
    want = structural_vote_reference(x)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"K8 differs from its plain version (max {err})")
    log(f"[K8] {VOTE_N} maps equal to the plain version on the card "
        f"(max_abs_err {err})")
    edge_errs: dict = {}
    for call, want in k8_edge_calls():
        _cmp("structural_vote", call(), want, edge_errs)
    log(f"[K8] equal to the plain version on K8_EDGE_CASES {K8_EDGE_CASES} "
        f"(max_abs_err {edge_errs})")
    res = {}
    for n in (BATCH, VOTE_N):
        xn = x[:n].contiguous()
        bound, by, nbytes, ops = vote_bound(xn)
        kernel, plain = (lambda: structural_vote(xn)), (lambda: structural_vote_reference(xn))
        ms, plain_ms = graph_ms(kernel), graph_ms(plain)
        call, plain_call = call_ms(kernel, 2000), call_ms(plain, 200)
        log(f"[K8] N={n}: device time per call (CUDA graph) kernel {ms:.6f} ms, "
            f"plain {plain_ms:.6f} ms; called from Python kernel {call:.6f} ms, "
            f"plain {plain_call:.6f} ms; bound {bound:.6f} ms by {by} "
            f"({nbytes} B, {ops} ops)")
        res[n] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    res["max_abs_err"] = err
    return res


def phase_main_path(tmp: pathlib.Path):
    frames = natural_sequence(W, H, FRAMES, seed0=7, bit_depth=8)
    y, u, v = (np.stack([f[i] for f in frames]).astype(np.uint8) for i in range(3))
    yuv = tmp / f"natural_{W}x{H}.yuv"
    write_yuv420(yuv, y, u, v)
    t0 = time.perf_counter()
    preds = {(comp, qp): CompPredictor.from_trained(
        comp == "Luma", CKPT / f"{comp}_Q_QP{qp}.msgpack",
        CKPT / f"{comp}_BD_QP{qp}.msgpack") for comp, qp in PREDICTORS}
    log(f"[main] loaded {len(preds)} predictors in {time.perf_counter() - t0:.2f} s")
    # One cold run first, so the measured run sees loaded CUDA modules.
    run = dict(predictors=preds, seq_name="natural", subsample=1,
               qps=(22, 27, 32, 37))
    cold = predict_sequence(yuv, W, H, out_dir=tmp / "cold", **run)
    log(f"[main] cold run: net {sum(cold.net.values()):.3f} s, "
        f"post {sum(cold.post.values()):.3f} s")

    structural_vote.launches = 0
    times = predict_sequence(yuv, W, H, out_dir=tmp / "out", **run)
    launches = structural_vote.launches
    check(launches > 0, "K8 was not launched on the main path")

    ctus = FRAMES * (W // 64) * (H // 64)
    log(f"[main] {W}x{H} x {FRAMES} frames, {ctus} CTUs per predictor, "
        f"batch {BATCH}; K8 launches {launches}")
    log(f"[main] blocking {times.blocking:.4f} s")
    for key in times.net:
        log(f"[main] {key[0]} QP{key[1]}: net {times.net[key]:.4f} s "
            f"({ctus / times.net[key]:.1f} CTU/s), post {times.post[key]:.4f} s")
    total_net = sum(times.net.values())
    log(f"[main] net stage: {len(times.net) * ctus / total_net:.1f} CTU "
        f"predictions/s over {len(times.net)} predictors")

    hp, wp = H // 64 * 64, W // 64 * 64
    q4, q8 = hp // 4 * wp // 4, hp // 8 * wp // 8
    per_frame = 2 * q4 + q8 + 3 * q4
    for comp, qp in PREDICTORS:
        path = tmp / "out" / f"natural_{comp}_QP{qp}_PartitionMat.txt"
        vals = np.array(path.read_bytes().split(), dtype=np.int64)
        check(len(vals) == FRAMES * per_frame,
              f"{path.name}: {len(vals)} lines, want {FRAMES * per_frame}")
        f = vals.reshape(FRAMES, per_frame)
        check(np.isin(f[:, :2 * q4], (0, 1)).all(), f"{path.name}: edge values")
        check(np.isin(f[:, 2 * q4:2 * q4 + q8], (0, 1, 2, 3)).all(),
              f"{path.name}: QT depths")
        check(np.isin(f[:, 2 * q4 + q8:], (-1, 0, 1)).all(),
              f"{path.name}: directions")
    log(f"[main] {len(PREDICTORS)} PartitionMat files of {per_frame} lines "
        f"per frame")
    return preds, blocks_for_sequence(y, u, v), launches


def phase_cpu_vs_card(preds: dict, blocks) -> None:
    luma_in, chroma_in = blocks
    for comp, qp in PREDICTORS:
        x = luma_in if comp == "Luma" else chroma_in
        x = x[np.linspace(0, len(x) - 1, 16).astype(int)]
        cpu = CompPredictor.from_trained(
            comp == "Luma", CKPT / f"{comp}_Q_QP{qp}.msgpack",
            CKPT / f"{comp}_BD_QP{qp}.msgpack", device="cpu")
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
        raw_cpu = [t.numpy() for t in cpu.forward(xt)]
        raw_gpu = [t.cpu().numpy() for t in preds[(comp, qp)].forward(xt.cuda())]
        errs = [float(np.abs(a - b).max()) for a, b in zip(raw_cpu, raw_gpu)]
        check(max(errs) <= RAW_TOL, f"{comp} QP{qp}: raw maps differ by {errs}")
        qt_cpu = cpu.predict(x)[0]
        qt_gpu = preds[(comp, qp)].predict(x)[0]
        pooled = raw_cpu[0].reshape(-1, 4, 2, 4, 2).max(axis=(2, 4))
        near = np.abs(pooled - np.floor(pooled) - 0.5) < RAW_TOL
        exempt = near.any(axis=(1, 2))
        same = (qt_cpu == qt_gpu).all(axis=(1, 2))
        check(bool((same | exempt).all()),
              f"{comp} QP{qp}: voted QT maps differ away from a threshold")
        log(f"[cpu-vs-card] {comp} QP{qp}: max |raw diff| qt {errs[0]:.3g} "
            f"bt {errs[1]:.3g} dire {errs[2]:.3g} (tol {RAW_TOL}); voted QT "
            f"equal on {int(same.sum())}/16 maps; {int(near.sum())} pooled "
            f"values within tol of a rounding threshold")


def phase_profile(preds: dict, blocks) -> None:
    """Where the net stage's time goes: one Luma QP32 ``predict`` of the
    main path's CTUs under torch.profiler, device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, pred = blocks[0], preds[("Luma", 32)]
    pred.predict(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict(x)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    if not rows:
        log("[profile] the profiler recorded no device time: not measured")
        return
    busy = sum(r[0] for r in rows)
    log(f"[profile] Luma QP32 predict, {len(x)} CTUs: wall {wall_ms:.3f} ms, "
        f"device busy {busy:.3f} ms, idle share {1 - busy / wall_ms:.3f}")
    for ms, count, name in rows[:12]:
        log(f"[profile]   {ms:9.3f} ms  x{count:<4d} {name[:110]}")


# ---------------------------------------------------------------------------
# The encode path: kernels K1, K2, K3, K4, K7 and the map-driven wave encode
# ---------------------------------------------------------------------------

DEVICE = "cuda"
ENC_W, ENC_H, ENC_FRAMES, ENC_QP = 1920, 1080, 2, 22   # JVET CTC class B
SMALL_W, SMALL_H = 416, 240                              # class D
BD = 10
ENC_KERNELS = {  # name: (wrapper, source, the TPU kernel it replaces)
    "ref_gather": (ref_gather, "pmp_vvc_tpu_torch/csrc/ref_gather.cu",
                   "pmp_vvc_tpu/codec/wavefront.py:97"),
    "intra_rmd": (intra_rmd, "pmp_vvc_tpu_torch/csrc/intra_rmd.cu",
                  "pmp_vvc_tpu/ops/intra_generic.py:142"),
    "mip_rmd": (mip_select, "pmp_vvc_tpu_torch/csrc/mip_rmd.cu",
                "pmp_vvc_tpu/ops/mip_generic.py:54"),
    "tq": (tq, "pmp_vvc_tpu_torch/csrc/tq.cu",
           "pmp_vvc_tpu/ops/tq_generic.py:96, pmp_vvc_tpu/codec/wavefront.py:598"),
    "tq_mts": (tq_mts, "pmp_vvc_tpu_torch/csrc/tq_mts.cu",
               "pmp_vvc_tpu/codec/wavefront.py:188"),
    "cclm": (cclm_select, "pmp_vvc_tpu_torch/csrc/cclm.cu",
             "pmp_vvc_tpu/ops/cclm_generic.py:40"),
    "wave_scatter": (wf.wave_scatter, "pmp_vvc_tpu_torch/csrc/wave_scatter.cu",
                     "pmp_vvc_tpu/codec/wavefront.py:655"),
}
# K4 with the LMCS chroma residual scale (K6b) is listed on its own: the same
# wrapper, whose launches with the scale also count on ``tq.crs_launches``.
K6B = ("tq_crs", "pmp_vvc_tpu_torch/csrc/tq.cu", "pmp_vvc_tpu/codec/wavefront.py:558")
# Scalar integer operations per sample, counted from the kernels' inner
# loops: an angular / planar sample of K2 (4 taps, rounding, clip, PDPC);
# one sample's share of K2's 8x8 Hadamard SATD (6 butterfly stages, abs,
# sum); K4's per-coefficient quantise / RD zeroing / dequantise, and its
# per-sample residual, SSE and rate work; a K3 sample's two upsampling
# passes, and a K3 reduced sample's 8-term product; K4's sign-data hiding
# scan per group slot, and per move tried where a group's parity is wrong.
# K5 runs K4's stages once per candidate with the same per-coefficient,
# per-sample and per-slot counts (transform skip: the quantiser and the
# sample work only), plus one operation per multiply-add of its transforms
# and 16 x 48 LFNST products and one per sample of its legality count, all
# int32 but for OPS_RD_FLOAT of each coefficient's OPS_QUANT (the RD gain's
# two conversions, difference, two squares, difference and division, its
# float64 conversion and sum, the comparison) and OPS_COST a candidate
# (``k5_ops``). K6a downsamples one luma sample pair per chroma sample (7
# operations), predicts U and V (4 each) and scores four SATDs; the joint
# Cb-Cr trial adds a third round trip and, per sample, the joint residual and
# two reconstructions with their SSE. K6b adds per CU the 128 neighbour
# samples' sum, and per sample of each round trip the forward scale (shift,
# add, division, clip, sign) and the inverse (clip, product, add, shift,
# clip, sign). K4's and K5's integer and float counts are each bounded
# against its own rate (``k4_ops``, ``k5_ops``). A multiply-add counts one operation at
# the int32 rate (INT32_PER_CLOCK_PER_SM counts one result per multiply-add)
# and two at the float32 rate (67e12 counts an FMA as two).
OPS_PRED, OPS_SATD, OPS_QUANT, OPS_SAMPLE = 12, 8, 30, 10
OPS_RD_FLOAT, OPS_COST = 10, 4
OPS_UPSAMPLE, OPS_REDUCED, OPS_SDH_SLOT, OPS_SDH_MOVE = 10, 20, 5, 14
OPS_DOWNSAMPLE, OPS_LM = 7, 4
OPS_CRS_NEIGHBOUR, OPS_CRS_SAMPLE = 2, 12


# The coding tools of each slice's configuration, oldest first; the last is
# this slice's, the main path's.
TOOLS = {
    "no tools": {},
    "MIP + SDH": dict(mip=True, sign_hiding=True),
    "MIP + SDH + MTS + LFNST + TS": dict(mip=True, sign_hiding=True, mts_intra=True,
                                          lfnst=True, transform_skip=True),
    "MIP + SDH + MTS + LFNST + TS + CCLM + JCCR": dict(
        mip=True, sign_hiding=True, mts_intra=True, lfnst=True, transform_skip=True,
        cclm=True, joint_cbcr=True),
    "MIP + SDH + MTS + LFNST + TS + CCLM + JCCR + LMCS": dict(
        mip=True, sign_hiding=True, mts_intra=True, lfnst=True, transform_skip=True,
        cclm=True, joint_cbcr=True, lmcs=True, lmcs_chroma_scaling=True),
}
MAIN, PREVIOUS = list(TOOLS)[-1], list(TOOLS)[-2]
# the bench's configuration (bench.py:186-197 without rdo_fallback): the main
# path's tools, the host-only ALF with its chroma filter and CC-ALF, QP 32
BENCH = "bench tools"
TOOLS[BENCH] = dict(TOOLS[MAIN], alf=True, alf_chroma=True, ccalf=True, qp=32)


def enc_cfg(w: int, h: int, tools: str = MAIN, dual_tree: bool = True) -> VVCConfig:
    """The slices' configuration: dual tree (or single), map-driven MTT at
    L3, the bench's chroma QP table, deblocking and SAO, QP 22, and the coding
    tools ``TOOLS[tools]`` (transform skip up to 32x32; the bench's also its
    QP); every other tool off."""
    kw = {"qp": ENC_QP, **TOOLS[tools]}
    return VVCConfig(width=w, height=h, dual_tree=dual_tree, sao=True,
                     deblocking_disabled=False, chroma_qp_start_minus26=-9,
                     chroma_qp_points=((9, 12), (4, 5), (11, 7)),
                     log2_min_cb=2, max_mtt_depth_intra=3, max_bt_intra=32,
                     max_tt_intra=32, **kw)


def kernel_rows(pad: int, scale: int, seed: int, width: int, height: int):
    """(B, 8) int32 rows: every CU size of the pad class (luma units), each
    in its own cell of a shuffled grid (CUs of one step never overlap),
    flush with the cell's top-left or bottom-right corner so that frame
    edges are met; random order ids; then two padding rows."""
    rng = np.random.RandomState(seed)
    big = pad * scale
    sides = [s for s in (4, 8, 16, 32, 64, 128) if s <= big]
    sizes = [(w, h) for w, h in itertools.product(sides, sides)
             if big == 32 or max(w, h) > big // 2]
    cells = rng.permutation((width // big) * (height // big))
    rows = []
    for i, (w, h) in enumerate(sizes):
        cy, cx = divmod(int(cells[i]), width // big)
        corner = i % 2
        x, y = cx * big + corner * (big - w), cy * big + corner * (big - h)
        rows.append((rng.randint(2), x, y, w, h, rng.randint(0, 400), 1, 0))
    rows += [(0, 0, 0, 0, 0, 0, 0, 0)] * 2
    return np.array(rows, np.int32)


def kernel_planes(seed: int, width: int, height: int, scale: int):
    """Recon and original planes (2 frames) and a partly coded order grid;
    the first CU's region holds a full-swing checkerboard original."""
    rng = np.random.RandomState(seed)
    H, W = height // scale, width // scale
    yy, xx = np.mgrid[0:H, 0:W]
    rec = np.stack([np.clip(512 + 300 * np.sin(xx / (7 + f)) * np.cos(yy / 11)
                            + rng.randn(H, W) * 20, 0, 1023) for f in range(2)])
    org = np.clip(rec + rng.randn(2, H, W) * rng.choice([2, 40, 300]), 0, 1023)
    org[:, :8, :8] = 1023 * (np.add.outer(np.arange(8), np.arange(8)) % 2)
    og = rng.randint(-1, 400, (2, height // 4, width // 4))
    og[1, :, ::3] = -1
    return (rec.astype(np.int32), org.astype(np.int32), og.astype(np.int32))


# K2's tie and edge cases: the kind of each CU per luma class, (kind, w, h).
# "flat": flat references (every candidate predicts the same constant) and
# a flat original, so that all 35 RMD costs are equal and planar must win;
# "mode 2" / "mode 66": the original is that mode's prediction (cost 0), so
# it wins and the refinement's clamp repeats it; "random": kernel_planes'
# content. 4xN and Nx4 CUs (4x4 SATD tiles) occur among them.
RMD_TIE_CASES = ("flat: planar wins a 35-way tie", "mode 2 wins", "mode 66 wins", "4xN", "Nx4")
RMD_TIES = {
    32: (("flat", 16, 16), ("flat", 8, 32), ("mode 2", 32, 32), ("mode 2", 4, 16),
         ("mode 66", 32, 16), ("mode 66", 16, 4), ("random", 4, 32), ("random", 4, 8),
         ("random", 32, 4), ("random", 8, 4)),
    64: (("flat", 64, 64), ("mode 2", 64, 32), ("mode 2", 4, 64), ("mode 66", 32, 64),
         ("mode 66", 64, 4), ("random", 4, 64), ("random", 64, 16)),
}
FLAT_REC, FLAT_ORG = 512, 600


def tie_inputs(P: int, seed: int, ties, target, prepare=None, width: int = 256,
               height: int = 192):
    """(rows, rec, org, og, kinds) as numpy for tie cases in the P-pad luma
    class: one CU of each (kind, w, h) of ``ties`` in its own P x P cell (at
    the cell's top-left), then one padding row. A "flat" CU's references
    (the recon from one sample above-left to 2w right and 2h down) are
    FLAT_REC and its original FLAT_ORG; the flat CUs take the last cells,
    so that their flat recon reaches no other CU's references. A "random"
    CU keeps kernel_planes' content. Any other kind is a target: its
    original is ``target(refs, rows, kinds, P)``'s (B, P, P) prediction
    from its references; it lies off the frame's top row and left column
    and comes after every coded CU (order 400), so that its references are
    the recon's and not one substituted constant. ``prepare(rec, og, kind,
    row)``, where given, shapes a CU's neighbourhood before the flat CUs'
    recon is written."""
    rng = np.random.RandomState(seed)
    rec, org, og = kernel_planes(seed, width, height, 1)
    nx, ncells = width // P, (width // P) * (height // P)
    group = lambda k: k if k in ("flat", "random") else "target"  # noqa: E731
    free = rng.permutation(ncells)
    cells = {}
    for kind in ("flat", "target", "random"):
        for i, (k, _, _) in enumerate(ties):
            if group(k) != kind:
                continue
            if kind == "flat":          # the last cell still free
                cells[i] = max(free)
            else:                       # the first free (interior for a target)
                cells[i] = next(c for c in free if kind == "random" or
                                (c >= nx and c % nx > 0))
            free = free[free != cells[i]]
    rows, kinds = [], []
    for i, (kind, w, h) in enumerate(ties):
        cy, cx = divmod(cells[i], nx)
        fi, x, y = rng.randint(2), cx * P, cy * P
        order = 400 if group(kind) == "target" else rng.randint(0, 400)
        rows.append((fi, x, y, w, h, order, 1, 0))
        kinds.append(kind)
    for kind, (fi, x, y, w, h, _, _, _) in zip(kinds, rows):
        if prepare is not None:
            prepare(rec, og, kind, (fi, x, y, w, h))
    for kind, (fi, x, y, w, h, _, _, _) in zip(kinds, rows):
        if kind == "flat":
            rec[fi, max(y - 1, 0):y + 2 * h, max(x - 1, 0):x + 2 * w] = FLAT_REC
            org[fi, y:y + h, x:x + w] = FLAT_ORG
    rows = np.array(rows + [(0,) * 8], np.int32)
    rows_t = torch.from_numpy(rows)
    refs = ref_gather_reference([torch.from_numpy(rec)], torch.from_numpy(og), rows_t, P, 1, BD)
    pred = target(refs, rows_t, kinds, P)
    for b, kind in enumerate(kinds):
        if group(kind) == "target":
            fi, x, y, w, h = rows[b, :5]
            org[fi, y:y + h, x:x + w] = pred[b, :h, :w]
    return rows, rec, org, og, kinds


def rmd_tie_inputs(P: int, seed: int):
    """``tie_inputs`` for K2's cases (``RMD_TIES``): a "mode M" CU's
    original is mode M's prediction (``predict_generic``)."""
    def target(refs, rows_t, kinds, P):
        modes = [int(k.split()[1]) if k.startswith("mode") else 0 for k in kinds] + [0]
        _, _, _, ws, hs, _, _ = unpack_rows(rows_t, 1)
        return predict_generic(*refs[0], torch.tensor(modes, dtype=torch.int32)[:, None], ws,
                               hs, pad=P, is_luma=True, bit_depth=BD)[:, 0].numpy()
    return tie_inputs(P, seed, RMD_TIES[P], target)


def rmd_tie_seen(rows: np.ndarray, kinds: list, modes: np.ndarray) -> np.ndarray:
    """(5,) counts of ``RMD_TIE_CASES`` among K2's chosen ``modes``; every
    flat CU must choose planar and every mode CU its mode."""
    seen = np.zeros(len(RMD_TIE_CASES), np.int64)
    for b, kind in enumerate(kinds):
        want = 0 if kind == "flat" else int(kind.split()[1]) if kind != "random" else None
        check(want is None or modes[b] == want, f"K2 chose mode {modes[b]} for a {kind} CU")
        w, h = rows[b, 3:5]
        seen += [kind == "flat", kind == "mode 2", kind == "mode 66", w == 4 < h, h == 4 < w]
    return seen


def rmd_tie_checks(P: int, seed: int, errs: dict) -> np.ndarray:
    """K2 against its plain version on ``rmd_tie_inputs``; the cases seen."""
    rows_np, rec, org, og, kinds = rmd_tie_inputs(P, seed)
    dev = lambda a: torch.from_numpy(a).to(DEVICE)  # noqa: E731
    rows, org_t = dev(rows_np), dev(org)
    refs = ref_gather([dev(rec)], dev(og), rows, P, 1, BD)
    mg = torch.zeros((2, og.shape[1], og.shape[2]), dtype=torch.uint8, device=DEVICE)
    got = intra_rmd(refs, org_t, mg, rows, P, True, BD)
    _cmp("intra_rmd", list(got), list(intra_rmd_reference(refs, org_t, mg, rows, P, True, BD)),
         errs)
    return rmd_tie_seen(rows_np, kinds, got[0].cpu().numpy())


# K3's tie and edge cases: the kind of each CU per luma class, (kind, w, h).
# "flat": flat references at FLAT_REC = 512, which at 10 bits make every
# MIP input zero, so that every candidate predicts 512, every MIP cost
# equals K2's planar cost and MIP must lose; "mip K": the original is MIP
# candidate K = t*16 + m's prediction (cost 0, strictly below K2's), so it
# must win with code 1 + K; "tie": references that alternate 512 +- TIE_D
# along the CU's top and left sides (coded before it), so that every Haar
# group averages 512, every MIP input is zero and every candidate gives
# the same prediction, which is the original: all tie at cost 0 below K2's,
# and the first, code 1, must win; "random": kernel_planes' content. Every
# size class occurs: 4x4 (sizeId 0, 32 candidates), 8x8 and 4xN / Nx4
# (sizeId 1, 16), the rest (sizeId 2, 12) up to 64x64; and the padding row.
MIP_TIE_CASES = ("flat: K2's winner keeps a tie", "MIP wins, t = 0", "MIP wins, t = 1",
                 "MIP wins a tie: the first candidate", "sizeId 0", "sizeId 1", "sizeId 2",
                 "padding row")
MIP_TIES = {
    32: (("flat", 16, 16), ("flat", 4, 4), ("mip 17", 4, 4), ("mip 3", 8, 8), ("mip 20", 4, 16),
         ("mip 6", 16, 4), ("mip 21", 16, 16), ("mip 2", 32, 8), ("tie", 4, 4), ("tie", 16, 8),
         ("random", 8, 8), ("random", 4, 4), ("random", 16, 32)),
    64: (("flat", 64, 64), ("mip 16", 64, 64), ("mip 5", 64, 16), ("mip 23", 4, 64),
         ("mip 1", 64, 4), ("tie", 64, 32), ("random", 16, 64), ("random", 64, 8)),
}
TIE_D = 37


def mip_tie_inputs(P: int, seed: int):
    """``tie_inputs`` for K3's cases (``MIP_TIES``): a "mip K" CU's
    original is MIP candidate K's prediction (``predict_mip_generic``), a
    "tie" CU's candidate 0's on its alternating references."""
    def prepare(rec, og, kind, row):
        fi, x, y, w, h = row
        if kind == "tie":
            rec[fi, y - 1, x:x + w] = FLAT_REC + TIE_D * (1 - 2 * (np.arange(w) % 2))
            rec[fi, y:y + h, x - 1] = FLAT_REC - TIE_D * (1 - 2 * (np.arange(h) % 2))
            og[fi, (y - 1) // 4, x // 4:(x + w) // 4] = 0
            og[fi, y // 4:(y + h) // 4, (x - 1) // 4] = 0

    def target(refs, rows_t, kinds, P):
        _, _, _, ws, hs, _, ok = unpack_rows(rows_t, 1)
        preds, _ = predict_mip_generic(refs[0, 0], refs[0, 1], torch.where(ok, ws, 4),
                                       torch.where(ok, hs, 4), pad=P, bit_depth=BD)
        k = [int(k.split()[1]) if k.startswith("mip") else 0 for k in kinds] + [0]
        return preds[torch.arange(len(k)), torch.tensor(k)].numpy()
    return tie_inputs(P, seed, MIP_TIES[P], target, prepare)


def mip_tie_seen(rows: np.ndarray, kinds: list, codes: np.ndarray) -> np.ndarray:
    """(8,) counts of ``MIP_TIE_CASES`` among K3's MIP ``codes``; every flat
    CU and the padding row must keep code 0, every "mip K" CU take 1 + K,
    every "tie" CU 1."""
    seen = np.zeros(len(MIP_TIE_CASES), np.int64)
    for b, (fi, x, y, w, h, _, live, _) in enumerate(rows):
        kind = kinds[b] if live > 0 else "padding row"
        want = (1 + int(kind.split()[1]) if kind.startswith("mip") else 1 if kind == "tie" else
                0 if kind in ("flat", "padding row") else None)
        check(want is None or codes[b] == want,
              f"K3 chose code {codes[b]} for a {kind} {w}x{h} CU (want {want})")
        sid = 0 if w == h == 4 else 1 if w == 4 or h == 4 or w == h == 8 else 2
        mip = kind.startswith("mip")
        seen += [kind == "flat", mip and want <= 16, mip and want > 16, kind == "tie",
                 live > 0 and sid == 0, live > 0 and sid == 1, live > 0 and sid == 2, live <= 0]
    return seen


def mip_tie_checks(P: int, seed: int, errs: dict) -> np.ndarray:
    """K3 against its plain version on ``mip_tie_inputs``, after K2; the
    cases seen."""
    rows_np, rec, org, og, kinds = mip_tie_inputs(P, seed)
    dev = lambda a: torch.from_numpy(a).to(DEVICE)  # noqa: E731
    rows, org_t = dev(rows_np), dev(org)
    refs = ref_gather([dev(rec)], dev(og), rows, P, 1, BD)
    mg = torch.zeros((2, og.shape[1], og.shape[2]), dtype=torch.uint8, device=DEVICE)
    modes, pred = intra_rmd(refs, org_t, mg, rows, P, True, BD)
    args = (refs, org_t, rows, pred, modes, P, BD)
    got = mip_select(*args)
    _cmp("mip_rmd", list(got), list(mip_select_reference(*args)), errs)
    return mip_tie_seen(rows_np, kinds, got[2].cpu().numpy())


# K5's tie and edge cases: per luma class, one call per lam (K5_TIES: {lam:
# (kind, w, h), ...}), all at internal QP 4 (K5_TIE_QP) with the main
# path's tools (``k5_tie_tools``). At QP 4 transform skip rebuilds every
# residual exactly (scale 16384 and qBits 14; inverse scale 64 and shift
# 6). With lam 0 a cost is its SSE: "exact": the residual is the inverse
# DCT-2 of one dequantised level set that DCT-2 rebuilds exactly (SSE 0,
# asserted), so DCT-2 and transform skip (and any MTS or LFNST slot that
# also reaches 0) tie at cost 0 and DCT-2, the first, must win; "zero": a
# zero residual, where DCT-2's cost 0 equals the zero TU's, so the CU must
# not be coded; "gated": a residual that is one LFNST basis function
# (``k5_inputs``) on a MIP CU below 16x16, where the gate keeps LFNST out
# (legal without it, asserted); "impulse": one impulse that only transform
# skip rebuilds exactly, so it must win; "random": residuals of +-20, every
# size of the class among them. With lam 2: "TS tie": impulses of 3, 3 and
# 6, whose transform-skip levels cost 2 (bits + 1) = 58 = SSE0 + 2 lam, the
# zero TU's cost, below every other candidate's (asserted): the zero TU
# must win, although transform skip's levels are not zero. Each call ends
# with a padding row. Every SSE stays below 2^24, where the JAX package's
# float32 sums are exact.
K5_TIE_CASES = ("DCT-2 wins a tie at cost 0", "zero TU wins a tie at cost 0",
                "LFNST gated off on a MIP CU", "transform skip wins an impulse",
                "zero TU wins a tie with coded levels", "32-pad CU", "64-pad CU",
                "padding row")
K5_TIES = {
    32: {0.0: (("exact", 8, 8), ("exact", 4, 16), ("exact", 32, 32), ("exact", 16, 4),
               ("zero", 16, 16), ("zero", 4, 4), ("zero", 32, 8), ("gated", 8, 8),
               ("gated", 4, 8), ("gated", 16, 8), ("impulse", 4, 4), ("impulse", 8, 16),
               ("impulse", 32, 32)),
         2.0: (("TS tie", 8, 4), ("TS tie", 8, 8), ("TS tie", 16, 16))},
    64: {0.0: (("exact", 64, 64), ("exact", 16, 64), ("zero", 64, 32), ("zero", 64, 4),
               ("gated", 64, 8), ("gated", 4, 64))},
}
K5_TIE_QP = 4


def k5_tie_tools(P: int) -> tuple:
    """(mts, lfnst, ts_max, sdh): the main path's luma tools in the P-pad
    class (MTS and transform skip in the 32-pad class only)."""
    return P <= 32, True, 32 if P <= 32 else 0, True


def _k5_one(P: int, lam: float, resid: np.ndarray, pred: np.ndarray, w: int, h: int):
    """``tq_mts_candidates`` at K5_TIE_QP and ``lam`` on one CU (mode 0, no
    MIP) whose residual over its pred is ``resid``: (candidates, zero TU's
    cost)."""
    org = np.zeros((1, P, P), np.int32)
    org[0] = pred + resid
    rows = torch.tensor([[0, 0, 0, w, h, 0, 1, 0]], dtype=torch.int32)
    cands, _, _, _, cost_zero = tq_mts_candidates(
        [torch.from_numpy(org)], torch.from_numpy(pred[None, None].copy()), rows, P,
        K5_TIE_QP, BD, True, lam, torch.tensor([0], dtype=torch.int32), None,
        *k5_tie_tools(P))
    return cands, float(cost_zero[0])


def _k5_resid(P: int, lam: float, kind: str, w: int, h: int, pred: np.ndarray,
              rng) -> np.ndarray:
    """A ``K5_TIES`` CU's (P, P) residual, zero outside its (h, w)."""
    ws, hs = torch.tensor([w]), torch.tensor([h])
    inside = np.zeros((P, P), np.int32)
    inside[:h, :w] = 1
    if kind == "zero":
        return np.zeros((P, P), np.int32)
    if kind == "random":
        return rng.randint(-20, 21, (P, P)).astype(np.int32) * inside
    if kind == "gated":                 # one LFNST basis function (mode 0: a MIP CU's)
        sec = np.zeros((1, P, P), np.int32)
        sec[0, 0, 0] = rng.choice([-1, 1]) * rng.randint(600, 1200)
        sec[0, 1, 0] = rng.randint(-400, 400)
        pri = inv_lfnst_generic(torch.from_numpy(sec), torch.zeros(1, dtype=torch.int32), ws,
                                hs, 1 + rng.randint(2))
        return ttq.inverse_transform_generic(pri, ws, hs, bit_depth=BD)[0].numpy() * inside
    for attempt in range(64):
        resid = np.zeros((P, P), np.int32)
        if kind == "exact":             # a level set that DCT-2 rebuilds exactly
            lev = np.zeros((1, P, P), np.int32)     # QP 4's step shrinks as the TU grows
            step = max(1, w * h // 16)
            lev[0, 0, 0] = rng.choice([-1, 1]) * rng.randint(step, 5 * step)
            lev[0, rng.randint(2), 1] = rng.randint(-3 * step, 3 * step + 1)
            deq = ttq.dequantize_generic(torch.from_numpy(lev), ws, hs, K5_TIE_QP, bit_depth=BD)
            resid = ttq.inverse_transform_generic(deq, ws, hs, bit_depth=BD)[0].numpy() * inside
        elif kind == "impulse":         # transform skip alone rebuilds it
            resid[rng.randint(h), rng.randint(w)] = rng.choice([-1, 1]) * rng.randint(200, 300)
        else:                           # TS tie: impulses 3, 3, 6 at distinct places
            at = rng.permutation(w * h)[:3]
            resid[at // w, at % w] = rng.choice([-1, 1], 3) * np.array([3, 3, 6])
        cands, cost_zero = _k5_one(P, lam, resid, pred, w, h)
        costs = [float(c[2][0]) for c in cands]
        if kind == "exact" and costs[0] == 0 and np.abs(resid).max() > 0:
            return resid
        if kind == "impulse" and costs[-1] == 0 and min(costs[:-1]) > 0:
            return resid
        if kind == "TS tie" and costs[-1] == cost_zero < min(costs[:-1]):
            return resid
    raise RuntimeError(f"no {kind} residual found for a {w}x{h} CU")


def k5_tie_inputs(P: int, seed: int) -> list:
    """K5's cases in the P-pad luma class: one (lam, rows, org, pred, modes,
    codes, kinds) call, as numpy, for each lam of ``K5_TIES[P]`` (the lam 0
    call also holds a "random" CU of every size of the class), each ending
    with a padding row: each CU in its own P x P cell of two 256x256
    frames, its prediction random in 400..623, its original the prediction
    plus the case's residual. Each case is asserted with the plain version:
    an "exact" CU's DCT-2 costs 0 (so does transform skip in the 32-pad
    class); a "zero" CU's DCT-2 and zero TU cost 0; a "gated" CU's LFNST
    candidates are out with its MIP code and legal without it; an "impulse"
    CU's transform skip alone costs 0; a "TS tie" CU's transform skip costs
    what its zero TU costs, and less than every other candidate; no SSE
    reaches 2^24."""
    rng = np.random.RandomState(seed)
    width = height = 256
    sides = [s for s in (4, 8, 16, 32, 64) if s <= P]
    sizes = [(w, h) for w, h in itertools.product(sides, sides) if P == 32 or max(w, h) > 32]
    calls = []
    for lam, cases in K5_TIES[P].items():
        ties = list(cases) + ([("random", w, h) for w, h in sizes] if lam == 0 else [])
        nx = width // P
        cells = rng.permutation(2 * nx * (height // P))[:len(ties)]
        org = rng.randint(400, 624, (2, height, width)).astype(np.int32)
        preds = np.zeros((len(ties) + 1, P, P), np.int32)
        rows, modes, codes, kinds = [], [], [], []
        for b, (kind, w, h) in enumerate(ties):
            fi, cell = divmod(int(cells[b]), nx * (height // P))
            cy, cx = divmod(cell, nx)
            x, y = cx * P, cy * P
            preds[b] = rng.randint(400, 624, (P, P))
            resid = _k5_resid(P, lam, kind, w, h, preds[b], rng)
            org[fi, y:y + h, x:x + w] = preds[b, :h, :w] + resid[:h, :w]
            rows.append((fi, x, y, w, h, rng.randint(0, 400), 1, 0))
            gated = kind == "gated"
            modes.append(0 if gated else rng.randint(0, 67))
            codes.append(1 + rng.randint(32) if gated or rng.rand() < 0.3 else 0)
            kinds.append(kind)
        rows.append((0,) * 8)
        modes.append(0)
        codes.append(0)
        rows, modes, codes = (np.array(a, np.int32) for a in (rows, modes, codes))
        # the cases are what they claim, in the plain version on the whole call
        args = ([torch.from_numpy(org)], torch.from_numpy(preds[None]), torch.from_numpy(rows),
                P, K5_TIE_QP, BD, True, lam, torch.from_numpy(modes))
        cands, resid, _, ok, cost_zero = tq_mts_candidates(*args, torch.from_numpy(codes),
                                                           *k5_tie_tools(P))
        open_cands = tq_mts_candidates(*args, None, *k5_tie_tools(P))[0]
        costs = torch.stack([c[2] for c in cands], 1).numpy()
        cost_zero = cost_zero.numpy()
        lf = np.array([c[4] for c in cands])
        ts = [i for i, c in enumerate(cands) if c[3] == 1]
        sse0 = (resid.long() ** 2).sum((1, 2)).numpy()
        check(sse0.max() < 2 ** 24 and costs[np.isfinite(costs)].max() < 2 ** 24,
              "a K5 tie case's SSE reaches 2^24")
        for b, kind in enumerate(kinds):
            c = costs[b]
            if kind == "exact":
                check(c[0] == 0 and (not ts or c[ts[0]] == 0) and sse0[b] > 0,
                      f"exact {rows[b, 3]}x{rows[b, 4]}: costs {c}")
            elif kind == "zero":
                check(c[0] == 0 and cost_zero[b] == 0, f"zero: costs {c}")
            elif kind == "gated":
                check(not np.isfinite(c[lf > 0]).any() and
                      np.isfinite(np.array([float(open_cands[i][2][b]) for i in
                                            np.nonzero(lf > 0)[0]])).any(),
                      f"gated {rows[b, 3]}x{rows[b, 4]}: costs {c}")
            elif kind == "impulse":
                check(c[ts[0]] == 0 and np.delete(c, ts[0]).min() > 0, f"impulse: costs {c}")
            elif kind == "TS tie":
                check(c[ts[0]] == cost_zero[b] < np.delete(c, ts[0]).min() and
                      cands[ts[0]][0][b].any(), f"TS tie: costs {c}, zero TU {cost_zero[b]}")
        check(not ok[-1], "the last row is the padding row")
        calls.append((lam, rows, org, preds, modes, codes, kinds))
    return calls


def k5_tie_seen(rows: np.ndarray, kinds: list, lev: np.ndarray, tr: np.ndarray,
                lf: np.ndarray) -> np.ndarray:
    """(8,) counts of ``K5_TIE_CASES`` among K5's results (``lev`` (B, P, P),
    ``tr``, ``lf`` (B,)): an "exact" CU must be coded with DCT-2 (mts_idx
    0, lfnst_idx 0), a "zero" or "TS tie" CU and the padding row not coded,
    a "gated" CU must not take LFNST, an "impulse" CU must take transform
    skip."""
    seen = np.zeros(len(K5_TIE_CASES), np.int64)
    P = lev.shape[-1]
    for b, (fi, x, y, w, h, _, live, _) in enumerate(rows):
        kind = kinds[b] if live > 0 else "padding row"
        coded = bool(lev[b].any())
        uncoded = not coded and tr[b] == 0 and lf[b] == 0
        want = {"exact": coded and tr[b] == 0 and lf[b] == 0, "zero": uncoded,
                "gated": lf[b] == 0, "impulse": coded and tr[b] == 1 and lf[b] == 0,
                "TS tie": uncoded, "padding row": uncoded}.get(kind, True)
        check(want, f"K5 on a {kind} {w}x{h} CU: coded {coded}, mts_idx {tr[b]}, "
              f"lfnst_idx {lf[b]}")
        seen += [kind == "exact", kind == "zero", kind == "gated", kind == "impulse",
                 kind == "TS tie", live > 0 and P == 32, live > 0 and P == 64, live <= 0]
    return seen


def k5_tie_checks(P: int, seed: int, errs: dict) -> np.ndarray:
    """K5 against its plain version on ``k5_tie_inputs``; the cases seen."""
    seen = np.zeros(len(K5_TIE_CASES), np.int64)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)  # noqa: E731
    for lam, rows_np, org, pred, modes, codes, kinds in k5_tie_inputs(P, seed):
        args = ([dev(org)], dev(pred[None]), dev(rows_np), P, K5_TIE_QP, BD, True, lam,
                dev(modes), dev(codes), *k5_tie_tools(P))
        got = tq_mts(*args)
        _cmp("tq_mts", list(got), list(tq_mts_reference(*args)), errs)
        lev, _, tr, lf = (t.cpu().numpy() for t in got)
        seen += k5_tie_seen(rows_np, kinds, lev[0], tr, lf)
    return seen


# K6a's tie and edge cases: per chroma class (pad: 16 and 32 of the wave
# path, 4 of the RDO's chroma tree), (kind, w, h) in luma units, besides a
# "random" CU of every size the class admits (sides of 2 and non-square CUs
# whose short side is 4 among them). Each CU has its own 2P x 2P luma cell
# of two 256x256 frames, at the cell's top-left; every kind but "random"
# and "none" has both neighbours coded before it (order 400). "tie": DM's
# prediction is LM's, so the SATDs tie and DM must keep the CU; "gate off":
# the original is LM's prediction (SATD 0) and the CCLM gate is off, so DM
# must keep it; "LM wins": the same with the gate on, so LM must win;
# "clip": luma 400 above and 440 left of the CU against chroma 200 above and
# 800 left (U; V is 1023 - U), so the slope is clamped to +-15, and luma 300
# in the CU's top half and 600 in its bottom half, so LM clips at 0 and at
# pel_max; "flat": one luma value over the template; "two": only the side of
# 2 has a neighbour, so the template holds two samples; "none": no
# neighbour; "CTU top": on luma row 128; "edge": flush with the frame's
# right and bottom edges. Each call ends with a padding row.
CCLM_TIE_CASES = ("DM kept a SATD tie", "LM better, gate off", "LM chosen", "LM clipped at 0",
                  "LM clipped at pel_max", "flat template", "two-sample template",
                  "no neighbours", "CTU top row", "right and bottom frame edges",
                  "chroma side of 2", "non-square, short side 4", "padding row")
CCLM_TIES = {
    16: (("tie", 16, 16), ("tie", 4, 8), ("gate off", 32, 32), ("gate off", 8, 32),
         ("LM wins", 32, 8), ("LM wins", 4, 4), ("clip", 16, 16), ("clip", 32, 8),
         ("flat", 16, 8), ("flat", 4, 16), ("two", 4, 16), ("two", 32, 4), ("none", 8, 8),
         ("none", 4, 4), ("CTU top", 32, 16), ("CTU top", 4, 8), ("edge", 32, 32),
         ("edge", 8, 4)),
    32: (("tie", 64, 64), ("tie", 64, 4), ("gate off", 64, 32), ("LM wins", 16, 64),
         ("clip", 64, 64), ("clip", 8, 64), ("flat", 64, 16), ("two", 4, 64), ("two", 64, 4),
         ("none", 64, 8), ("CTU top", 64, 64), ("edge", 64, 32)),
    4: (("tie", 8, 8), ("tie", 4, 4), ("gate off", 8, 4), ("LM wins", 4, 8), ("clip", 8, 8),
        ("flat", 8, 8), ("two", 4, 8), ("two", 8, 4), ("none", 4, 4), ("CTU top", 8, 8),
        ("edge", 8, 4)),
}
CCLM_TIE_W, CCLM_TIE_H = 256, 256


def _cclm_tie_places(P: int, rng) -> list:
    """(fi, x, y, w, h, order) of each CU of ``CCLM_TIES[P]`` and then a
    "random" CU of every size of the class, in distinct 2P x 2P cells; and
    the kinds."""
    C, W, H = 2 * P, CCLM_TIE_W, CCLM_TIE_H
    sides = [s for s in (4, 8, 16, 32, 64) if s <= C]
    # the most constrained first: the CTU top row, the edge cell, the
    # other kinds (off the frame's top row and left column), "random"
    ties = sorted(CCLM_TIES[P], key=lambda t: (t[0] != "CTU top", t[0] != "edge")) + \
        [("random", w, h) for w, h in itertools.product(sides, sides)
         if P != 32 or max(w, h) == C]
    free = {(f, cx, cy) for f in range(2) for cx in range(W // C) for cy in range(H // C)}
    places = []
    for kind, w, h in ties:
        if kind == "edge":
            cell = (rng.randint(2), W // C - 1, H // C - 1)
        else:
            ok = [c for c in sorted(free) if kind == "random" or
                  (c[1] >= 1 and c[2] >= 1 and (kind != "CTU top" or c[2] * C == 128))]
            cell = ok[rng.randint(len(ok))]
        free.discard(cell)
        fi, cx, cy = cell
        x, y = (W - w, H - h) if kind == "edge" else (cx * C, cy * C)
        order = rng.randint(0, 400) if kind == "random" else 400
        places.append((fi, x, y, w, h, order))
    return places, [k for k, _, _ in ties]


def cclm_tie_inputs(P: int, seed: int):
    """K6a's cases in the P-pad chroma class (``CCLM_TIES``) as numpy: (rows,
    luma recon, chroma recon (2, F, H/2, W/2), originals (2, F, H/2, W/2),
    order grid, DM predictions (2, B, P, P), kinds, facts), the last row a
    padding row. ``facts`` holds what each live row is, from the plain
    version on these inputs: "tie" (equal SATDs), "lm better", "clip0" and
    "clip max" (LM clipped at 0, at pel_max), "flat", "two", "none". Each
    kind is asserted to be what it claims."""
    rng = np.random.RandomState(seed)
    W, H = CCLM_TIE_W, CCLM_TIE_H
    rec, org, og = kernel_planes(seed, W, H, 2)
    ry = cclm_luma(rec, seed)
    places, kinds = _cclm_tie_places(P, rng)
    for (fi, x, y, w, h, _), kind in zip(places, kinds):
        cx, cy, cw, ch = x // 2, y // 2, w // 2, h // 2
        above, left = (fi, (y - 1) // 4, slice(x // 4, (x + 2 * w) // 4)), \
            (fi, slice(y // 4, (y + 2 * h) // 4), (x - 1) // 4)
        if kind == "random":
            continue
        og[above], og[left] = 0, 0
        if kind == "none" or kind == "two" and w != 4:
            og[fi, (y - 1) // 4, x // 4] = -1       # the above neighbour's cell
        if kind == "none" or kind == "two" and w == 4:
            og[fi, y // 4, (x - 1) // 4] = -1       # the left neighbour's cell
        if kind == "flat":
            ry[fi, y - 2:y, x - 1:x + w] = 600
            ry[fi, y:y + h, x - 3:x] = 600
        elif kind == "clip":
            ry[fi, y - 2:y, x - 1:x + w] = 400
            ry[fi, y:y + h, x - 3:x] = 440
            ry[fi, y:y + h // 2, x:x + w] = 300
            ry[fi, y + h // 2:y + h, x:x + w] = 600
            rec[fi, cy - 1, cx - 1:cx + 2 * cw] = 200
            rec[fi, cy:cy + 2 * ch, cx - 1] = 800
    rows = np.array([(*p, 1, rng.randint(2) if k == "random" else int(k != "gate off"))
                     for p, k in zip(places, kinds)] + [(0,) * 8], np.int32)
    recs = np.stack([rec, 1023 - rec]).astype(np.int32)
    orgs = np.stack([org, 1023 - org]).astype(np.int32)
    t = torch.from_numpy
    rows_t, og_t, ry_t = t(rows), t(og), t(ry)
    refs = ref_gather_reference([t(recs[0]), t(recs[1])], og_t, rows_t, P, 2, BD)
    # DM: the original with noise of +-2 or +-200 per CU, zero outside it
    fi, cxs, cys, cws, chs, _, ok = (a.numpy() for a in unpack_rows(rows_t, 2))
    d = np.arange(P)
    inside = (d[None, :, None] < chs[:, None, None]) & (d[None, None, :] < cws[:, None, None])
    ys = np.clip(cys[:, None, None] + d[None, :, None], 0, H // 2 - 1)
    xs = np.clip(cxs[:, None, None] + d[None, None, :], 0, W // 2 - 1)
    amp = rng.choice([2, 200], len(rows))[:, None, None]
    dm = np.stack([np.clip(o[fi[:, None, None], ys, xs] +
                           rng.randint(-1, 2, (len(rows), P, P)) * amp, 0, 1023) * inside
                   for o in orgs]).astype(np.int32)
    args = lambda: (refs, ry_t, [t(orgs[0]), t(orgs[1])], og_t, rows_t, t(dm), P, BD)  # noqa
    lm = cclm_costs(*args())[0].numpy()
    for b, kind in enumerate(kinds):
        if kind == "tie":
            dm[:, b] = lm[:, b]
        elif kind in ("gate off", "LM wins"):
            orgs[:, fi[b], cys[b]:cys[b] + chs[b], cxs[b]:cxs[b] + cws[b]] = \
                lm[:, b, :chs[b], :cws[b]]
    _, cost_dm, cost_lm = (c.numpy() for c in cclm_costs(*args()))
    la, aa = cclm_neighbours(og_t, rows_t)
    interior, models, case = cclm_models(
        ry_t, *unpack_rows(rows_t, 2)[:5], pad_c=P, top_u=refs[0, 0], left_u=refs[0, 1],
        top_v=refs[1, 0], left_v=refs[1, 1], bit_depth=BD, left_avail=la, above_avail=aa)
    raw = torch.stack([(a[:, None, None] * interior >> s[:, None, None]) + b_[:, None, None]
                       for a, b_, s in models]).numpy()
    facts = {"tie": cost_dm == cost_lm, "lm better": cost_lm < cost_dm,
             "clip0": ((raw < 0) & inside).any((0, 2, 3)),
             "clip max": ((raw > (1 << BD) - 1) & inside).any((0, 2, 3)),
             "flat": case["flat"].numpy(), "two": case["two"].numpy(),
             "none": case["none"].numpy(), "both": (la & aa).numpy()}
    claims = {"tie": "tie", "gate off": "lm better", "LM wins": "lm better", "flat": "flat",
              "two": "two", "none": "none", "CTU top": "both", "edge": "both"}
    check(max(cost_dm.max(), cost_lm.max()) < 2 ** 24, "a K6a tie case's SATD reaches 2^24")
    for b, kind in enumerate(kinds):
        check(kind not in claims or facts[claims[kind]][b],
              f"K6a tie case {kind} {rows[b, 3]}x{rows[b, 4]} is not what it claims")
        check(kind != "clip" or facts["clip0"][b] and facts["clip max"][b] and facts["both"][b],
              f"K6a tie case clip {rows[b, 3]}x{rows[b, 4]} does not clip both ways")
    check(not ok[-1], "the last row is the padding row")
    return rows, ry, recs, orgs, og, dm, kinds, facts


def cclm_tie_seen(rows: np.ndarray, kinds: list, facts: dict, pred: np.ndarray,
                  use: np.ndarray) -> np.ndarray:
    """(13,) counts of ``CCLM_TIE_CASES`` among K6a's results (``pred`` (2,
    B, P, P), ``use`` (B,)): a "tie" and a "gate off" CU must keep DM, an
    "LM wins" CU must take LM, the padding row must give zeros and 0."""
    seen = np.zeros(len(CCLM_TIE_CASES), np.int64)
    for b, (fi, x, y, w, h, _, live, _) in enumerate(rows):
        kind = kinds[b] if live > 0 else "padding row"
        want = {"tie": 0, "gate off": 0, "LM wins": 1, "padding row": 0}.get(kind)
        check(want is None or use[b] == want, f"K6a on a {kind} {w}x{h} CU: use_lm {use[b]}")
        check(live > 0 or not pred[:, b].any(), "K6a wrote a padding row")
        cw, ch = w // 2, h // 2
        f = {k: bool(v[b]) and live > 0 for k, v in facts.items()} if live > 0 else \
            dict.fromkeys(facts, False)
        seen += [kind == "tie" and f["tie"] and use[b] == 0,
                 kind == "gate off" and f["lm better"] and use[b] == 0,
                 live > 0 and use[b] == 1, f["clip0"], f["clip max"], f["flat"], f["two"],
                 f["none"], live > 0 and f["both"] and y % 128 == 0,
                 live > 0 and x + w == CCLM_TIE_W and y + h == CCLM_TIE_H,
                 live > 0 and min(cw, ch) == 2, live > 0 and min(cw, ch) == 4 and cw != ch,
                 live <= 0]
    return seen


def cclm_tie_checks(P: int, seed: int, errs: dict) -> np.ndarray:
    """K6a against its plain version on ``cclm_tie_inputs``; the cases seen."""
    rows_np, ry, recs, orgs, og, dm, kinds, facts = cclm_tie_inputs(P, seed)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)  # noqa: E731
    rows, og_t = dev(rows_np), dev(og)
    refs = ref_gather([dev(recs[0]), dev(recs[1])], og_t, rows, P, 2, BD)
    args = (refs, dev(ry), [dev(orgs[0]), dev(orgs[1])], og_t, rows, dev(dm), P, BD)
    got = cclm_select(*args)
    _cmp("cclm", list(got), list(cclm_select_reference(*args)), errs)
    return cclm_tie_seen(rows_np, kinds, facts, *(g.cpu().numpy() for g in got))


# K4's tie and edge cases: per chroma class (pad 16 and 32 of the wave path,
# 4 of the device RDO's), calls of one lam each at internal QP K4_TIE_QP
# (qp_j the same), dw 1, sign-data hiding as the class's calls have it
# (``K4_TIE_SDH``): {pad: ((lam, cases), ...)},
# each case (kind, w, h) in luma units, each CU in its own P x P chroma cell
# of two 256x256 frames, its two predictions random in 400..623 and its
# originals the predictions plus the case's residuals (zero outside the CU).
# The first call (lam 0) also holds a "random" CU of every size of the class
# (+-20, U and V apart: odd differences of both signs, chroma sides of 2);
# each call ends with a padding row. "joint tie": U's residual rebuilds
# exactly and so does its negation, V's, so the joint residual is U's and
# rebuilds exactly too: the joint cost 0 equals the separate cost 0, and the
# separate TUs must stay; "zero": zero residuals, whose coded TUs cost 0 as
# the zero TUs do: no level; "joint zero": equal U and V residuals, so the
# joint TU has no level. Every other kind has equal U and V residuals.
# "zero tie": a residual whose coded TU costs what its zero TU costs
# although it has levels (the call's lam, an integer, makes it so): the
# zero TU must win; "SDH tie": a coefficient group whose parity is wrong
# and whose least move error two moves reach: the first must be taken.
# "RD threshold": the call's lam makes one group's gain sum equal lam * (3
# nz + 1.5) exactly (the group is kept); "lam3": the call's lam makes the
# gain of a level of 1 equal 3 lam exactly (the level is kept), in a group
# that survives. The gains are exact dyadic numbers whose sums float32
# holds in any order. Each call runs with the
# trial, with the trial and the LFNST region on every CU, without the trial,
# and with the trial and the chroma residual scale (CUs of 4 or fewer chroma
# samples keep the unit scale); every case is asserted with the plain
# pieces, every SSE stays below 2^24.
K4_TIE_CASES = ("separate kept a joint-cost tie", "zero TU won a tie at cost 0",
                "zero TU won a tie with coded levels", "joint TU quantised to zero",
                "odd difference > 0", "odd difference < 0", "group gain sum at its threshold",
                "gain equal to 3 lam", "SDH moves tied", "CRS gate (<= 4 samples)",
                "LFNST region cut a joint level", "chroma side of 2", "padding row")
K4_TIES = {
    16: ((0.0, (("joint tie", 16, 16), ("joint tie", 32, 8), ("zero", 16, 16), ("zero", 4, 4),
                ("joint zero", 32, 32), ("joint zero", 4, 16))),
         ("zero tie", (("zero tie", 8, 8), ("SDH tie", 16, 16), ("SDH tie", 32, 16))),
         ("RD threshold", (("RD threshold", 16, 16),)),
         ("lam3", (("lam3", 16, 16),))),
    32: ((0.0, (("joint tie", 64, 64), ("joint tie", 64, 8), ("zero", 64, 32),
                ("joint zero", 64, 64))),
         ("zero tie", (("zero tie", 64, 16), ("SDH tie", 64, 64))),
         ("RD threshold", (("RD threshold", 64, 64),)),
         ("lam3", (("lam3", 64, 32),))),
    4: ((0.0, (("joint tie", 8, 8), ("zero", 4, 4), ("zero", 8, 8), ("joint zero", 8, 4))),
        ("zero tie", (("zero tie", 8, 8),)),
        ("RD threshold", (("RD threshold", 8, 8),)),
        ("lam3", (("lam3", 8, 8),))),
}
K4_TIE_QP = 34
K4_TIE_SDH = {16: True, 32: True, 4: False}   # the RDO's 4-pad calls hide no sign
K4_TIE_N = 128                        # candidates a search tries at once


def k4_trips(res: np.ndarray, w: int, h: int, lam: float, sdh: bool = True):
    """The plain round trip, before the coded-vs-zero decision, of N residual
    tiles ``res`` (N, P, P) of one chroma (h, w) size at K4_TIE_QP, dw 1:
    (levels, SSE, coded cost, zero TU's cost, coefficients, levels before
    sign-data hiding), the costs float32 as ``tq_reference`` computes them."""
    n = res.shape[0]
    ws, hs = (torch.full((n,), s, dtype=torch.int32) for s in (w, h))
    r = torch.from_numpy(np.ascontiguousarray(res, np.int32))
    coef = ttq.forward_transform_generic(r, ws, hs, bit_depth=BD)
    lev0 = ttq.rd_cleanup_generic(ttq.quantize_generic(coef, ws, hs, K4_TIE_QP, bit_depth=BD),
                                  coef, ws, hs, K4_TIE_QP, lam, bit_depth=BD)
    lev = apply_sdh_generic(lev0, coef, ws, hs, K4_TIE_QP, bit_depth=BD) if sdh else lev0
    rr = ttq.inverse_transform_generic(
        ttq.dequantize_generic(lev, ws, hs, K4_TIE_QP, bit_depth=BD), ws, hs, bit_depth=BD)
    sse = ((rr - r).long() ** 2).sum((1, 2))
    cost = sse.float() + torch.tensor(lam, dtype=torch.float32) * ttq.bits_proxy(lev)
    cost0 = (r.long() ** 2).sum((1, 2)).float() + torch.tensor(np.float32(lam * 2.0))
    return lev, sse, cost, cost0, coef, lev0


def _k4_groups(res: np.ndarray, w: int, h: int):
    """Each 4x4 group's RD quantities of N residual tiles at K4_TIE_QP, as
    ``rd_cleanup_generic`` computes them: (float32 gains (N, P, P), the
    groups' float32 gain sums and nonzero counts (N, P/4, P/4), the levels,
    whether each group's sums are exact in float32 in any order: its gains'
    numerators c^2 - e^2 sum to less than 2^24 in magnitude)."""
    n, P = res.shape[0], res.shape[-1]
    ws, hs = (torch.full((n,), s, dtype=torch.int32) for s in (w, h))
    coef = ttq.forward_transform_generic(torch.from_numpy(np.ascontiguousarray(res, np.int32)),
                                         ws, hs, bit_depth=BD)
    lev = ttq.quantize_generic(coef, ws, hs, K4_TIE_QP, bit_depth=BD)
    t_shift, sqrt2 = ttq._geom_v(ws, hs, BD)
    divisor = torch.exp2(2.0 * t_shift.float() - sqrt2.float())
    fc = coef.float()
    e = fc - ttq._dequant_unclipped(lev, ws, hs, K4_TIE_QP, BD).float()
    gain = (fc * fc - e * e) / divisor[:, None, None]
    g = gain.double().reshape(-1, P // 4, 4, P // 4, 4).sum((2, 4)).float()
    nz = (lev != 0).reshape(-1, P // 4, 4, P // 4, 4).sum((2, 4))
    num = (fc.double() ** 2 - e.double() ** 2).abs().reshape(-1, P // 4, 4, P // 4, 4)
    return gain.numpy(), g.numpy(), nz.numpy(), lev.numpy(), (num.sum((2, 4)) < 2 ** 24).numpy()


def _f32_lam(target: np.float32, factor: np.float32):
    """A float32 lam with float32(lam * factor) == target, or None."""
    lam0 = np.float32(np.float64(target) / np.float64(factor))
    for k in range(-3, 4):
        lam = np.float32(lam0 + k * np.spacing(lam0))
        if lam > 0 and np.float32(lam * factor) == target:
            return lam
    return None


def _k4_case(P: int, kind: str, w: int, h: int, lam, rng):
    """A ``K4_TIES`` CU's (U, V) residual tiles (P, P) of chroma size (w, h)
    and the call's lam: ``lam``, or where that is None the float32 lam the
    case sets; the case asserted with the plain pieces, sign-data hiding as
    ``K4_TIE_SDH``."""
    sdh = K4_TIE_SDH[P]
    inside = np.zeros((P, P), np.int32)
    inside[:h, :w] = 1
    rnd = lambda m, n=1: rng.randint(-m, m + 1, (n, P, P)).astype(np.int32) * inside  # noqa
    if kind == "random":
        return rnd(20)[0], rnd(20)[0], lam
    if kind == "zero":
        z = np.zeros((P, P), np.int32)
        lev, _, cost, cost0, _, _ = k4_trips(z[None], w, h, lam, sdh)
        check(float(cost[0]) == float(cost0[0]) == 0, "zero: the costs are not 0")
        return z, z, lam
    if kind == "joint zero":
        r = rnd(40)[0]
        return r, r, lam
    if kind == "joint tie":             # one level set that rebuilds exactly, and its negation
        for _ in range(8):
            lev = np.zeros((K4_TIE_N, P, P), np.int32)
            lev[:, 0, 0] = rng.choice([-1, 1], K4_TIE_N) * rng.randint(1, 4, K4_TIE_N)
            lev[np.arange(K4_TIE_N), rng.randint(min(h, 2), size=K4_TIE_N), 1] = \
                rng.randint(-2, 3, K4_TIE_N)
            ws, hs = (torch.full((K4_TIE_N,), s, dtype=torch.int32) for s in (w, h))
            deq = ttq.dequantize_generic(torch.from_numpy(lev), ws, hs, K4_TIE_QP, bit_depth=BD)
            a = ttq.inverse_transform_generic(deq, ws, hs, bit_depth=BD).numpy() * inside
            ok = np.abs(a).max((1, 2)) > 0
            for sign in (1, -1):
                lv, sse = k4_trips(sign * a, w, h, lam, sdh)[:2]
                ok &= (sse.numpy() == 0) & lv.flatten(1).any(1).numpy()
            if ok.any():
                a = a[np.argmax(ok)]
                return a, -a, lam
    elif kind == "zero tie":            # lam with a coded TU's cost equal to its zero TU's
        top = 61 * max(1, int(np.sqrt(w * h)) // 4)   # impulses that larger TUs code
        for _ in range(64):
            r = np.zeros((K4_TIE_N, P, P), np.int32)
            for _k in range(rng.randint(1, 4)):
                r[np.arange(K4_TIE_N), rng.randint(h, size=K4_TIE_N),
                  rng.randint(w, size=K4_TIE_N)] = \
                    rng.choice([-1, 1], K4_TIE_N) * rng.randint(3, top, K4_TIE_N)
            lev, sse = k4_trips(r, w, h, 2.0, sdh)[:2]
            bits = ttq.bits_proxy(lev).numpy()
            sse0 = (r.astype(np.int64) ** 2).sum((1, 2))
            gap, nb = sse0 - sse.numpy(), bits.astype(np.int64) - 2
            for n in np.nonzero(lev.flatten(1).any(1).numpy() & (gap > 0) &
                                (gap % np.maximum(nb, 1) == 0))[0]:
                lam_f = float(gap[n] // nb[n])   # an integer: every product exact
                lv, _, cost, cost0 = k4_trips(r[n:n + 1], w, h, lam_f, sdh)[:4]
                if lv.any() and float(cost[0]) == float(cost0[0]):
                    return r[n], r[n], lam_f
    elif kind == "SDH tie":             # a wrong parity whose least move error two moves reach
        for _ in range(16):
            r = rnd(40, K4_TIE_N)
            _, _, _, _, coef, lev0 = k4_trips(r, w, h, lam, sdh)
            ws, hs = (torch.full((K4_TIE_N,), s, dtype=torch.int32) for s in (w, h))
            mism, err = sdh_moves(lev0, coef, ws, hs, K4_TIE_QP, bit_depth=BD)[:2]
            low = err.min(-1).values
            ok = (mism & torch.isfinite(low) & ((err == low[..., None]).sum(-1) >= 2)).any(1)
            if ok.any():
                b = int(torch.nonzero(ok)[0])
                return r[b], r[b], lam
    elif kind == "RD threshold":        # lam with float32(lam * (3 nz + 1.5)) == the group's sum
        for _ in range(16):
            r = rnd(60, K4_TIE_N)
            _, g, nz, _, exact = _k4_groups(r, w, h)
            for n, gy, gx in zip(*np.nonzero((nz > 0) & (g > 0) & exact)):
                lam_f = _f32_lam(g[n, gy, gx],
                                 np.float32(np.float32(3.0) * np.float32(nz[n, gy, gx]) +
                                            np.float32(1.5)))
                if lam_f is not None:
                    return r[n], r[n], float(lam_f)
    elif kind == "lam3":                # lam with float32(lam * 3) == a kept level's gain
        for _ in range(16):
            r = rnd(60, K4_TIE_N)
            gain, g, nz, lev, exact = _k4_groups(r, w, h)
            exact = exact.repeat(4, 1).repeat(4, 2)
            for n, y, x in zip(*np.nonzero((np.abs(lev) == 1) & (gain > 0) & exact)):
                lam_f = _f32_lam(gain[n, y, x], np.float32(3.0))
                thr = np.float32(lam_f * np.float32(np.float32(3.0) *
                                                    np.float32(nz[n, y // 4, x // 4]) +
                                                    np.float32(1.5))) if lam_f else None
                if lam_f is not None and not g[n, y // 4, x // 4] < thr:
                    return r[n], r[n], float(lam_f)
    raise RuntimeError(f"no {kind} residual found for a {w}x{h} chroma TU")


def k4_tie_inputs(P: int, seed: int) -> list:
    """K4's cases in the P-pad chroma class (``K4_TIES``): one (lam, rows,
    originals (2, 2, 128, 128), predictions (2, B, P, P), kinds) call, as
    numpy, for each entry of ``K4_TIES[P]``. The rows are in luma units
    (scale 2); each ends with a padding row."""
    rng = np.random.RandomState(seed)
    Hc = Wc = 128
    sides = [s for s in (4, 8, 16, 32, 64) if s <= 2 * P]
    sizes = [(w, h) for w, h in itertools.product(sides, sides) if P != 32 or max(w, h) > 32]
    calls = []
    for c, (lam, cases) in enumerate(K4_TIES[P]):
        ties = list(cases) + ([("random", w, h) for w, h in sizes] if c == 0 else [])
        nx = Wc // P
        cells = rng.permutation(2 * nx * (Hc // P))[:len(ties)]
        org = rng.randint(400, 624, (2, 2, Hc, Wc)).astype(np.int32)
        pred = rng.randint(400, 624, (2, len(ties) + 1, P, P)).astype(np.int32)
        rows, kinds, res = [], [], []
        lam_call = lam if isinstance(lam, float) else None
        for b, (kind, w, h) in enumerate(ties):
            ru, rv, lam_b = _k4_case(P, kind, w // 2, h // 2, lam_call, rng)
            lam_call = lam_b if lam_call is None else lam_call
            fi, cell = divmod(int(cells[b]), nx * (Hc // P))
            cy, cx = divmod(cell, nx)
            for pl, r in enumerate((ru, rv)):
                org[pl, fi, cy * P:cy * P + h // 2, cx * P:cx * P + w // 2] = \
                    (pred[pl, b] + r)[:h // 2, :w // 2]
            rows.append((fi, 2 * cx * P, 2 * cy * P, w, h, rng.randint(0, 400), 1, 0))
            kinds.append(kind)
            res.append((ru, rv))
        rows.append((0,) * 8)
        rows = np.array(rows, np.int32)
        check(org.min() >= 0 and org.max() <= 1023, "a K4 tie original leaves the sample range")
        sse0 = max(int((r.astype(np.int64) ** 2).sum()) for pair in res for r in pair)
        check(sse0 < 2 ** 24, "a K4 tie case's SSE reaches 2^24")
        calls.append((lam_call, rows, org, pred, kinds))
    return calls


def k4_tie_seen(rows: np.ndarray, kinds: list, org: np.ndarray, pred: np.ndarray,
                lev: np.ndarray, joint: np.ndarray) -> np.ndarray:
    """(13,) counts of ``K4_TIE_CASES`` among K4's results with the trial
    (``lev`` (2, B, P, P), ``joint`` (B,)), the CRS gate and the region not
    counted: a "joint tie" CU must keep both separate TUs coded, a "zero"
    CU and the padding row have no level, a "zero tie" CU no level in U, a
    "joint zero" CU no joint TU."""
    seen = np.zeros(len(K4_TIE_CASES), np.int64)
    P = lev.shape[-1]
    for b, (fi, x, y, w, h, _, live, _) in enumerate(rows):
        kind = kinds[b] if live > 0 else "padding row"
        coded = [bool(lev[pl, b].any()) for pl in (0, 1)]
        want = {"joint tie": joint[b] == 0 and all(coded),
                "zero": joint[b] == 0 and not any(coded), "zero tie": not coded[0],
                "joint zero": joint[b] == 0,
                "padding row": joint[b] == 0 and not any(coded)}.get(kind, True)
        check(want, f"K4 on a {kind} {w}x{h} CU: coded {coded}, joint {joint[b]}")
        d = np.zeros((P, P), np.int64)
        if live > 0:
            cx, cy, cw, ch = x // 2, y // 2, w // 2, h // 2
            d[:ch, :cw] = (org[0, fi, cy:cy + ch, cx:cx + cw] - pred[0, b, :ch, :cw]) - \
                (org[1, fi, cy:cy + ch, cx:cx + cw] - pred[1, b, :ch, :cw])
        odd = d % 2 != 0
        seen += [kind == "joint tie", kind == "zero", kind == "zero tie", kind == "joint zero",
                 int((odd & (d > 0)).sum()), int((odd & (d < 0)).sum()),
                 kind == "RD threshold", kind == "lam3", kind == "SDH tie", 0, 0,
                 live > 0 and min(w, h) == 4, live <= 0]
    return seen


def k4_tie_checks(P: int, seed: int, errs: dict) -> np.ndarray:
    """K4 against its plain version on ``k4_tie_inputs``, with the trial,
    with the trial and the LFNST region on every CU, without the trial, and
    with the trial and the chroma residual scale; the cases seen."""
    seen = np.zeros(len(K4_TIE_CASES), np.int64)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)  # noqa: E731
    lut = device_crs_lut()
    for lam, rows_np, org, pred, kinds in k4_tie_inputs(P, seed):
        rng = np.random.RandomState(seed + len(rows_np))
        rows, orgs, p = dev(rows_np), [dev(org[0]), dev(org[1])], dev(pred)
        ry = dev(rng.randint(0, 1024, (2, 256, 256)).astype(np.int32))
        og = dev(rng.randint(-1, 400, (2, 64, 64)).astype(np.int32))
        active = torch.ones_like(rows[:, 0])
        args = (orgs, p, rows, P, 2, K4_TIE_QP, BD, True, lam, 1.0, K4_TIE_SDH[P])
        for act, jccr, crs in ((None, True, False), (active, True, False), (None, False, False),
                               (None, True, True)):
            a = args + (act, jccr, K4_TIE_QP)
            if crs:
                scale = torch.empty_like(rows[:, 0])
                got = tq(*a, crs_src=(ry, og, lut), crs_out=scale)
                want = crs_scale_reference(ry, og, rows, lut, BD)
                _cmp(K6B[0], list(got) + [scale], list(tq_reference(*a, crs=want)) + [want], errs)
                seen[K4_TIE_CASES.index("CRS gate (<= 4 samples)")] += int(
                    ((rows[:, 6] > 0) & (rows[:, 3] // 2 * (rows[:, 4] // 2) <= 4) &
                     (scale == UNIT_SCALE)).sum())
                continue
            got = tq(*a)
            _cmp("tq", list(got), list(tq_reference(*a)), errs)
            if act is None and jccr:
                seen += k4_tie_seen(rows_np, kinds, org, pred, got[0].cpu().numpy(),
                                    got[2].cpu().numpy())
        # where the region removes a level of the joint TU (plain pieces)
        tiles = [ttq._orgs_inside(o, rows, P, 2) for o in orgs]
        (ou, inside, ws, hs, ok), (ov, *_) = tiles
        joint = torch.round(((ou - p[0]) * inside - (ov - p[1]) * inside).double() / 2).int()
        lev_j = [ttq._tq_tile(p[0] + joint, p[0], inside, ws, hs, ok, K4_TIE_QP, BD, True, lam,
                              1.0, K4_TIE_SDH[P], a)[0] for a in (None, active.bool())]
        seen[K4_TIE_CASES.index("LFNST region cut a joint level")] += int(
            ((lev_j[0] != 0) & (lev_j[1] == 0)).sum())
    return seen


# ---------------------------------------------------------------------------
# K1's and K7's edge cases, held exactly to their plain versions
# ---------------------------------------------------------------------------

K1_EDGE_CASES = ("CU at x = 0", "CU at y = 0", "CU at (0, 0)", "no neighbour available",
                 "only the last top cell available", "only the first bottom-left cell available",
                 "runs of ids equal to oi and of -1", "reach past the right edge",
                 "reach past the bottom edge", "w != h", "side of 2", "frame index 1",
                 "samples 0 and 1023", "padding row")
# (pad, scale): the wave path's four tile classes, the device RDO's 8-pad
# luma and 4-pad chroma classes
K1_EDGE_CLASSES = ((32, 1), (64, 1), (16, 2), (32, 2), (8, 1), (4, 2))
K7_EDGE_CASES = ("past the plane's right edge", "past the plane's bottom edge",
                 "2-wide chroma CU at an odd 2-sample offset",
                 "4-wide chroma CU at a 2-sample offset", "4x4 luma CU", "64x64 luma CU",
                 "grid cells past the grid", "0 to 4 grids", "levels at the int16 limits",
                 "frame index 1", "padding row", "sentinel kept outside the CUs")
K7_EDGE_CLASSES = ((32, 1), (64, 1), (16, 2), (32, 2))
EDGE_W, EDGE_H = 256, 192              # luma samples; one frame per CU
K7_SENTINEL = (-7, -12345, 165)        # recon, level and grid samples nothing writes


def edge_case_applies(case: str, P: int, scale: int) -> bool:
    """Whether ``case`` of K1_EDGE_CASES / K7_EDGE_CASES can occur in the
    (P, scale) class."""
    if case in ("side of 2", "2-wide chroma CU at an odd 2-sample offset",
                "4-wide chroma CU at a 2-sample offset"):
        return scale == 2
    if case == "4x4 luma CU":
        return scale == 1
    if case == "64x64 luma CU":
        return (P, scale) == (64, 1)
    return True


def k1_edge_inputs(P: int, scale: int, seed: int):
    """K1's edge cases in the (P, scale) class: (rows (B, 8), the planes (one
    for luma, U and V = 1023 - U for chroma, (F, H, W) int32), the order grid
    (F, H_luma/4, W_luma/4) int32), one frame per CU so that each case has a
    grid of its own; the last row is a padding row."""
    rng = np.random.RandomState(seed)
    L = P * scale                      # the class's largest side, luma units
    half = max(L // 2, 4)
    W, H, GW, GH = EDGE_W, EDGE_H, EDGE_W // 4, EDGE_H // 4
    # (x, y, w, h, grid) in luma units
    cus = [(0, 0, L, half, "random"), (0, 64, half, half, "random"),
           (64, 0, half, L, "random"), (64, 64, half, half, "none"),
           (32, 32, L, half, "last top"), (32, 16, half, L, "first bottom-left"),
           (64, 64, L, L, "runs"), (W - half, 96, half, half, "random"),
           (96, H - half, half, half, "random"), (W - half, H - half, half, half, "random"),
           (64, 64, half, half, "0 and 1023")]
    if scale == 2:
        cus += [(40, 40, 4, min(8, L), "random"), (44, 48, min(16, L), 4, "random")]
    F = len(cus)
    Hp, Wp = H // scale, W // scale
    plane = rng.randint(0, 1024, (F, Hp, Wp))
    og = rng.randint(-1, 400, (F, GH, GW))
    rows = []
    for f, (x, y, w, h, grid) in enumerate(cus):
        oi = int(rng.randint(100, 400))
        xs, ys = x // scale, y // scale
        if grid == "none":
            og[f] = rng.choice([-1, oi, oi + 7], (GH, GW))
        elif grid == "last top":
            og[f] = -1
            og[f, (ys - 1) * scale // 4, (xs + 2 * P - 1) * scale // 4] = oi - 1
        elif grid == "first bottom-left":
            og[f] = -1
            og[f, (ys + 2 * P - 1) * scale // 4, (xs - 1) * scale // 4] = 0
        elif grid == "runs":
            runs = np.concatenate([np.full(rng.randint(1, 3), (oi, -1, oi - 1)[k % 3])
                                   for k in range(GH + GW)])
            og[f] = runs[np.add.outer(np.arange(GH), np.arange(GW))]
        elif grid == "0 and 1023":
            yy, xx = np.mgrid[0:Hp, 0:Wp]
            plane[f] = 1023 * ((yy // 3 + xx // 5) % 2)
            og[f] = 0
        rows.append((f, x, y, w, h, oi, 1, 0))
    rows.append((0, 0, 0, L, L, 5, 0, 0))
    plane = plane.astype(np.int32)
    planes = [plane] if scale == 1 else [plane, (1023 - plane).astype(np.int32)]
    return np.array(rows, np.int32), planes, og.astype(np.int32)


def k1_edge_seen(rows: np.ndarray, og: np.ndarray, P: int, scale: int,
                 refs: np.ndarray) -> np.ndarray:
    """How often each K1_EDGE_CASES case occurs on these rows; ``refs`` is
    the plain version's output (n, 4, B, 2P+3). The availability of each
    substitution entry is restated here from the rows and the grid."""
    fi, x, y, w, h, oi, live = (rows[:, k] for k in range(7))
    xs, ys, ws, hs = x // scale, y // scale, w // scale, h // scale
    Hp, Wp = EDGE_H // scale, EDGE_W // scale
    n2 = 2 * P
    s = np.arange(2 * n2 + 1)[None, :]
    j = np.where(s < n2, n2 - 1 - s, s - n2 - 1)
    left, corner = s < n2, s == n2
    row = np.where(left, ys[:, None] + j, ys[:, None] - 1)
    col = np.where(left, xs[:, None] - 1, np.where(corner, xs[:, None] - 1, xs[:, None] + j))
    ok = np.where(left, (row < Hp) & (xs[:, None] > 0) & (j < 2 * hs[:, None]),
                  np.where(corner, (xs[:, None] > 0) & (ys[:, None] > 0),
                           (col < Wp) & (ys[:, None] > 0) & (j < 2 * ws[:, None])))
    gy = np.clip(np.maximum(row, 0) * scale // 4, 0, og.shape[1] - 1)
    gx = np.clip(np.maximum(col, 0) * scale // 4, 0, og.shape[2] - 1)
    ids = og[fi[:, None], gy, gx]
    avail = ok & (ids >= 0) & (ids < oi[:, None])
    cell = 4 // scale
    on = live > 0
    unf = np.concatenate([refs[0, 0], refs[0, 1]], 1)
    seen = [on & (xs == 0), on & (ys == 0), on & (xs == 0) & (ys == 0),
            on & ~avail.any(1), on & avail[:, -1] & ~avail[:, :-cell].any(1),
            on & avail[:, 0] & ~avail[:, cell:].any(1),
            on & (ok & (ids == oi[:, None])).any(1) & (ok & (ids == -1)).any(1)
            & (np.abs(np.diff(avail.astype(int), axis=1)).sum(1) >= 2),
            on & (xs + 2 * ws > Wp), on & (ys + 2 * hs > Hp), on & (ws != hs),
            on & (scale == 2) & ((ws == 2) | (hs == 2)), on & (fi == 1),
            on & (unf == 0).any(1) & (unf == 1023).any(1), ~on]
    return np.array([int(c.sum()) for c in seen], np.int64)


def k7_edge_inputs(P: int, scale: int, seed: int):
    """K7's edge cases in the (P, scale) class: (rows (B, 8), rec and lev
    (n, B, P, P) int32 with levels at the int16 limits, codes (4, B) int32),
    one frame per CU so that no two CUs overlap; the last row is a padding
    row over frame 0's top-left corner."""
    rng = np.random.RandomState(seed)
    L = P * scale
    half = max(L // 2, 4)
    W, H = EDGE_W, EDGE_H
    cus = [(W - half, 96, L, half), (96, H - half, half, L), (W - 8, H - 8, L, L),
           (64, 64, L, L), (64, 64, half, half)]
    if scale == 1:
        cus += [(20, 36, 4, 4), (W - 4, 100, 4, 8)]
    else:                              # chroma x of 2, 6 and 6: 2-aligned only
        cus += [(4, 40, 4, min(16, L)), (12, 8, 4, 8), (12, 24, 8, 8), (W - 4, H - 8, 4, 16)]
    rows = np.array([(f, x, y, w, h, rng.randint(0, 400), 1, 0)
                     for f, (x, y, w, h) in enumerate(cus)] + [(0, 0, 0, L, L, 1, 0, 0)],
                    np.int32)
    n, B = 1 if scale == 1 else 2, len(rows)
    rec = rng.randint(0, 1024, (n, B, P, P)).astype(np.int32)
    lev = rng.randint(-32768, 32768, (n, B, P, P)).astype(np.int32)
    lev[:, :, 0, 0], lev[:, :, 0, 1] = -32768, 32767
    codes = rng.randint(0, 256, (4, B)).astype(np.int32)
    return rows, rec, lev, codes


def k7_edge_planes(n: int, scale: int, F: int, device) -> tuple:
    """(plane pairs, four code grids) of ``F`` frames filled with
    ``K7_SENTINEL``."""
    Hp, Wp = EDGE_H // scale, EDGE_W // scale
    planes = [(torch.full((F, Hp, Wp), K7_SENTINEL[0], dtype=torch.int32, device=device),
               torch.full((F, Hp, Wp), K7_SENTINEL[1], dtype=torch.int16, device=device))
              for _ in range(n)]
    grids = [torch.full((F, EDGE_H // 4, EDGE_W // 4), K7_SENTINEL[2], dtype=torch.uint8,
                        device=device) for _ in range(4)]
    return planes, grids


def k7_edge_seen(rows: np.ndarray, P: int, scale: int, lev: np.ndarray, ngrids: int,
                 kept: int) -> np.ndarray:
    """How often each K7_EDGE_CASES case occurs in one call with ``ngrids``
    grids; ``kept`` counts the sentinel samples left after it."""
    fi, x, y, w, h, _, live = (rows[:, k] for k in range(7))
    xs, ys, ws, hs = x // scale, y // scale, w // scale, h // scale
    Hp, Wp = EDGE_H // scale, EDGE_W // scale
    on = live > 0
    d = np.arange(P)
    inside = (d[None, :, None] < hs[:, None, None]) & (d[None, None, :] < ws[:, None, None]) & \
        (ys[:, None, None] + d[None, :, None] < Hp) & (xs[:, None, None] + d[None, None, :] < Wp)
    lim = lambda v: ((lev == v) & inside[None]).any((0, 2, 3))  # noqa: E731
    seen = [on & (xs + ws > Wp), on & (ys + hs > Hp),
            on & (scale == 2) & (ws == 2) & ((xs // 2) % 2 == 1),
            on & (scale == 2) & (ws == 4) & (xs % 4 == 2),
            on & (scale == 1) & (ws == 4) & (hs == 4),
            on & (scale == 1) & (ws == 64) & (hs == 64),
            on & (ngrids > 0) & ((x // 4 + w // 4 > EDGE_W // 4) | (y // 4 + h // 4 > EDGE_H // 4)),
            np.array([ngrids == 0 or ngrids == 4]), on & lim(-32768) & lim(32767),
            on & (fi == 1), ~on, np.array([kept > 0])]
    return np.array([int(c.sum()) for c in seen], np.int64)


def k1_edge_checks(errs: dict) -> dict:
    """K1 against its plain version on ``k1_edge_inputs`` of every class;
    {class: K1_EDGE_CASES counts}."""
    out = {}
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)  # noqa: E731
    for P, scale in K1_EDGE_CLASSES:
        rows_np, planes, og = k1_edge_inputs(P, scale, seed=P + scale)
        rows, og_t, ps = dev(rows_np), dev(og), [dev(p) for p in planes]
        want = ref_gather_reference(ps, og_t, rows, P, scale, BD)
        _cmp("ref_gather", ref_gather(ps, og_t, rows, P, scale, BD), want, errs)
        out[(P, scale)] = k1_edge_seen(rows_np, og, P, scale, want.cpu().numpy())
    return out


def k7_edge_checks(errs: dict) -> dict:
    """K7 against its plain version on ``k7_edge_inputs`` of every class,
    with 0 to 4 grids, planes and grids full of ``K7_SENTINEL``, and its
    wrapper refusing misaligned rows; {class: K7_EDGE_CASES counts}."""
    out = {}
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)  # noqa: E731
    for P, scale in K7_EDGE_CLASSES:
        rows_np, rec, lev, codes = k7_edge_inputs(P, scale, seed=P + scale)
        rows, rec_t, lev_t = dev(rows_np), dev(rec), dev(lev)
        seen = np.zeros(len(K7_EDGE_CASES), np.int64)
        for ngrids in range(5):
            planes, grids = k7_edge_planes(len(rec), scale, len(rows_np) - 1, DEVICE)
            scatter_both(rows, P, scale, planes, rec_t, lev_t,
                         [(g, dev(c)) for g, c in zip(grids[:ngrids], codes)], errs)
            kept = sum(int((t == s).sum()) for p in planes for t, s in zip(p, K7_SENTINEL)) + \
                sum(int((g == K7_SENTINEL[2]).sum()) for g in grids[:ngrids])
            seen += k7_edge_seen(rows_np, P, scale, lev, ngrids, kept)
        out[(P, scale)] = seen
    # K7 reads a row as two int4: rows off the 16-byte grain are refused
    # before any launch
    odd = torch.zeros(8 * len(rows_np) + 1, dtype=torch.int32, device=DEVICE)[1:].view(-1, 8)
    try:
        wf.wave_scatter(odd, P, scale, planes, rec_t, lev_t)
        refused = ""
    except ValueError as e:
        refused = str(e)
    check("16-byte aligned" in refused,
          f"wave_scatter did not refuse schedule rows off the 16-byte grain ({refused!r})")
    return out


def edge_cases_reached(kernel: str, cases, seen: dict) -> None:
    """Every case of ``cases`` occurred in every class where it can."""
    for (P, scale), counts in seen.items():
        missing = [c for c, k in zip(cases, counts) if k == 0 and edge_case_applies(c, P, scale)]
        check(not missing, f"{kernel}'s edge cases not reached at pad {P}, scale {scale}: "
                           f"{missing}")


def _cmp(name: str, got, want, errs: dict) -> None:
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    for g, w in zip(got, want):
        d = g.double() - w.double() if g.is_floating_point() else g.long() - w.long()
        err = float(d.abs().max()) if g.numel() else 0.0
        errs[name] = max(errs.get(name, 0.0), err)
        check(torch.equal(g, w), f"{name} differs from its plain version (max {err})")


def scatter_both(rows, pad, scale, planes, rec, lev, grids, errs):
    """K7 on ``planes`` and ``grids`` (in place) against its plain version
    on copies."""
    ref_planes = [(a.clone(), b.clone()) for a, b in planes]
    ref_grids = [(g.clone(), c) for g, c in grids]
    wf.wave_scatter(rows, pad, scale, planes, rec, lev, grids)
    wf.wave_scatter_reference(rows, pad, scale, ref_planes, rec, lev, ref_grids)
    _cmp("wave_scatter", [t for p in planes for t in p] + [g for g, _ in grids],
         [t for p in ref_planes for t in p] + [g for g, _ in ref_grids], errs)


def checked_step(scan, kind: str, P: int, row, errs: dict) -> None:
    """``_Scan.step`` with each kernel held against its plain version on
    the same inputs; the kernels' results carry the state forward."""
    ry, ru, rv, cY, cU, cV, mg, tg, pg, cg, lg = scan.state
    bd = scan.bd
    lf = None
    if kind != "chroma":
        refs = ref_gather([ry], scan.og4, row, P, 1, bd)
        _cmp("ref_gather", refs, ref_gather_reference([ry], scan.og4, row, P, 1, bd), errs)
        best, pred = intra_rmd(refs, scan.oy, mg, row, P, True, bd)
        _cmp("intra_rmd", [best, pred],
             list(intra_rmd_reference(refs, scan.oy, mg, row, P, True, bd)), errs)
        code = None
        if scan.mip:
            args = (refs, scan.oy, row, pred, best, P, bd)
            best, pred, code = mip_select(*args)
            _cmp("mip_rmd", [best, pred, code], list(mip_select_reference(*args)), errs)
        args = ([scan.oy], pred, row, P, scan.qp_y, bd, scan.rd_quant, scan.lam,
                best, code, *scan.luma_tools(P), scan.sdh)
        lev, rec, tr, lf = tq_mts(*args)
        _cmp("tq_mts", [lev, rec, tr, lf], list(tq_mts_reference(*args)), errs)
        grids = [(mg, best)] + ([(pg, code)] if scan.mip else []) + [(tg, tr), (lg, lf)]
        scatter_both(row, P, 1, [(ry, cY)], rec, lev, grids, errs)
        if kind == "luma":
            return
    Pc = P // 2
    refs = ref_gather([ru, rv], scan.og4c, row, Pc, 2, bd)
    _cmp("ref_gather", refs, ref_gather_reference([ru, rv], scan.og4c, row, Pc, 2, bd), errs)
    modes, pred = intra_rmd(refs, None, mg, row, Pc, False, bd)
    _cmp("intra_rmd", [modes, pred],
         list(intra_rmd_reference(refs, None, mg, row, Pc, False, bd)), errs)
    code = torch.zeros_like(row[:, 0])
    if scan.cclm:
        args = (refs, ry, [scan.ou, scan.ov], scan.og4c, row, pred, Pc, bd)
        pred, code = cclm_select(*args)
        _cmp("cclm", [pred, code], list(cclm_select_reference(*args)), errs)
    args = ([scan.ou, scan.ov], pred, row, Pc, 2, scan.qp_c, bd, scan.rd_quant,
            scan.lam, scan.dw_c, scan.sdh, lf, scan.jccr, scan.qp_j)
    if scan.crs_lut is None:
        out = tq(*args)
        _cmp("tq", list(out), list(tq_reference(*args)), errs)
    else:
        scale = torch.empty_like(row[:, 0])
        out = tq(*args, crs_src=(ry, scan.og4c, scan.crs_lut), crs_out=scale)
        want = crs_scale_reference(ry, scan.og4c, row, scan.crs_lut, bd)
        _cmp(K6B[0], list(out) + [scale], list(tq_reference(*args, crs=want)) + [want], errs)
    if scan.jccr:
        code = code + 2 * out[2]
    grids = [(cg, code)] if scan.cclm or scan.jccr else []
    scatter_both(row, Pc, 2, [(ru, cU), (rv, cV)], out[1], out[0], grids, errs)


def resid_tiles(orgs, pred, rows, P: int, scale: int, joint: bool = False) -> list:
    """Each plane's residual tiles (original - prediction over each CU), or
    with ``joint`` the joint Cb-Cr residual round((res_u - res_v) / 2)."""
    tiles = [ttq._orgs_inside(o, rows, P, scale) for o in orgs]
    res = [(t[0] - pred[i]) * t[1] for i, t in enumerate(tiles)]
    return [torch.round((res[0] - res[1]).double() / 2).int()] if joint else res


def sdh_groups(resids, rows, P: int, scale: int, qp: int, lam: float) -> tuple[int, int]:
    """(coefficient groups K4's sign-data hiding scans, groups whose parity it
    corrects) over these residual tiles (``resid_tiles``) in one K4 call,
    counted with the plain pieces."""
    _, _, _, ws, hs, _, ok = unpack_rows(rows, scale)
    lw, lh = ttq._log2(ws), ttq._log2(hs)
    per_tb = torch.from_numpy((_cg_tables(P) >= 0).any(-1).sum(-1)).to(rows.device)
    fixed = 0
    for resid in resids:
        coef = ttq.forward_transform_generic(resid, ws, hs, bit_depth=BD)
        lev = ttq.rd_cleanup_generic(ttq.quantize_generic(coef, ws, hs, qp, bit_depth=BD),
                                     coef, ws, hs, qp, lam, bit_depth=BD)
        fixed += int((sdh_moves(lev, coef, ws, hs, qp, bit_depth=BD)[0] & ok[:, None]).sum())
    return len(resids) * int(per_tb[(lw * 7 + lh).long()][ok].sum()), fixed


def k5_ops(rows: np.ndarray, P: int, k5) -> tuple[int, int, int]:
    """(integer operations, float operations, coefficient groups that
    sign-data hiding scans) of one K5 call, from ``k5`` = (mts, lfnst,
    ts_max, sdh, legal, gate): each candidate a CU runs (DCT-2 always; MTS
    where w, h <= 32; LFNST where the MIP gate allows; transform skip where
    w, h <= ts_max) costs its forward transform and quantisation, and a legal
    one (``legal``: (B, candidates) from ``tq_mts_candidates``, in its order)
    also its inverse and sums. A multiply-add counts one integer operation.
    LFNST needs only the secondary products on DCT-2's coefficients, its 16
    secondary coefficients' quantisation, and the inverse DCT-2 of the 8x8
    (4x4 below 8x8 TUs) region it fills."""
    mts, lfnst, ts_max, sdh, legal, gate = k5
    per_tb = (_cg_tables(P) >= 0).any(-1).sum(-1)
    int_ops = float_ops = groups = 0
    quant_int = OPS_QUANT - OPS_RD_FLOAT
    for b, (w, h) in enumerate(rows[:, 3:5]):
        if rows[b, 6] <= 0:
            continue
        n16 = 8 if (w, h) in ((4, 4), (8, 8)) else 16
        r = 8 if min(w, h) >= 8 else 4
        cands = [(min(w, 32), min(h, 32), "tr")]
        cands += [(min(w, 16), min(h, 16), "tr")] * 4 if mts else []
        cands += [(r, r, "lfnst")] * 2 if lfnst else []
        cands += [(w, h, "ts")] if ts_max else []
        for c, (kw, kh, kind) in enumerate(cands):
            if (kind == "tr" and 1 <= c <= 4 and max(w, h) > 32) or \
                    (kind == "lfnst" and not gate[b]) or (kind == "ts" and max(w, h) > ts_max):
                continue
            float_ops += OPS_COST
            if kind == "ts":
                int_ops += quant_int * w * h + (OPS_SAMPLE * w * h if legal[b, c] else 0)
                continue
            if kind == "tr":
                fwd, inv, nq = h * kw * w + kh * kw * h, h * kw * kh + h * w * kw, kw * kh
            else:
                fwd, inv, nq = n16 * 48, 48 * n16 + h * r * r + h * w * r, 16
            int_ops += fwd + quant_int * nq + w * h
            float_ops += OPS_RD_FLOAT * nq
            if sdh:
                g = int(per_tb[int(np.log2(w)) * 7 + int(np.log2(h))])
                int_ops += g * 16 * OPS_SDH_SLOT
                groups += g
            if legal[b, c]:
                int_ops += inv + OPS_SAMPLE * w * h
    return int_ops, float_ops, groups


def k4_ops(w: np.ndarray, h: np.ndarray, n_tq: int, sdh, jccr, crs: bool) -> tuple[int, int]:
    """(integer operations, float operations) of one K4 call on live CUs of
    chroma sizes ``w``, ``h``, counted as ``k5_ops`` counts K5's: each of the
    ``n_tq`` round trips a CU its four products (a multiply-add one integer
    operation), its quantiser and RD zeroing (OPS_QUANT a kept coefficient,
    OPS_RD_FLOAT of it float: the gain), its sample work (OPS_SAMPLE a
    sample) and its cost (OPS_COST, float); ``sdh``, ``jccr``: (groups
    scanned, groups corrected) of the planes' and the joint TU's sign-data
    hiding (``kernel_bounds``), each group's slots integer and each move's
    error float; the trial's joint residual and two reconstructions with
    their SSEs (two samples' work) and two costs; with ``crs``, the 128
    neighbours' sum and each round trip's forward and inverse scale."""
    kw, kh = np.minimum(w, 32), np.minimum(h, 32)
    macs = h * kw * w + kh * kw * h + h * kw * kh + h * w * kw
    samples = int((w * h).sum())
    int_ops = n_tq * (int((macs + (OPS_QUANT - OPS_RD_FLOAT) * kw * kh).sum()) +
                      OPS_SAMPLE * samples)
    float_ops = n_tq * (OPS_RD_FLOAT * int((kw * kh).sum()) + OPS_COST * len(w))
    for groups in (g for g in (sdh, jccr) if g is not None):
        int_ops += groups[0] * 16 * OPS_SDH_SLOT
        float_ops += groups[1] * 32 * OPS_SDH_MOVE
    if jccr is not None:
        int_ops += 2 * OPS_SAMPLE * samples
        float_ops += 2 * OPS_COST * len(w)
    if crs:
        int_ops += len(w) * 128 * OPS_CRS_NEIGHBOUR + n_tq * OPS_CRS_SAMPLE * samples
    return int_ops, float_ops


def kernel_bounds(name: str, rows: np.ndarray, P: int, scale: int, n: int,
                  modes=None, codes=None, sdh=None, k5=None, jccr=None,
                  ngrids: int = 0) -> tuple[float, str, int, int]:
    """(bound ms, bound_by, bytes, ops) of one call on these rows. ``modes``:
    K2's luma modes; ``codes``: K3's MIP codes; ``sdh``: (groups scanned,
    groups corrected) of a K4 call with sign-data hiding; ``jccr``: the same
    for the joint Cb-Cr TU of a K4 call with the trial ((0, 0) without
    sign-data hiding); ``k5``: what ``k5_ops`` reads of a K5 call;
    ``ngrids``: K7's code grids. ``tq_crs`` is K4 with the chroma residual
    scale: each live CU's 128 luma neighbours, two order-grid cells and one
    LUT entry in, each round trip's samples scaled forward and back."""
    live = rows[rows[:, 6] > 0]
    w, h = live[:, 3] // scale, live[:, 4] // scale
    B, pad_rows = len(rows), len(rows) - len(live)
    L = 2 * P + 3
    if name == "ref_gather":
        nbytes = n * (len(live) * (4 * P + 1) * 8 + B * 4 * L * 4) + B * 32
        ops = n * len(live) * (4 * P + 1) * 6
    elif name == "intra_rmd":
        nbytes = n * B * (4 * L * 4 + P * P * 4) + B * 32 + \
            (int((w * h).sum()) * 4 if modes is not None else 0)
        if modes is not None:           # luma RMD
            cands = 35 + 2 * (modes[rows[:, 6] > 0] >= 2) + 1
            ops = int((cands * w * h).sum()) * OPS_PRED + \
                int(((cands - 1) * w * h).sum()) * OPS_SATD
        else:
            ops = n * int((w * h).sum()) * OPS_PRED
    elif name == "mip_rmd":
        sid = np.where((w == 4) & (h == 4), 0,
                       np.where((w == 4) | (h == 4) | ((w == 8) & (h == 8)), 1, 2))
        n_modes, red_p = np.array([16, 8, 6])[sid], np.array([4, 4, 8])[sid]
        # every valid candidate, plus the winner again where MIP wins
        preds = 2 * n_modes + (codes[rows[:, 6] > 0] > 0)
        ops = int((preds * (w * h * OPS_UPSAMPLE + red_p ** 2 * OPS_REDUCED)).sum()) + \
            int(((2 * n_modes + 1) * w * h).sum()) * OPS_SATD
        # boundary rows, original and K2's prediction over each CU, the
        # weights of the size classes present, the prediction tiles out
        table = sum(int(n_modes[sid == k][0] * red_p[sid == k][0] ** 2) * 8 * 4
                    for k in set(sid.tolist()))
        nbytes = int((w + h).sum()) * 4 + int((w * h).sum()) * 8 + table + \
            B * P * P * 4 + B * (32 + 4 * 3)
    elif name in ("tq", K6B[0]):
        n_tq = n + (jccr is not None)   # the joint TU is a third round trip
        int_ops, float_ops = k4_ops(w, h, n_tq, sdh, jccr, name == K6B[0])
        ops = int_ops + float_ops
        t_ops = max(int_ops / int32_ops_per_s(), float_ops / FP32_OPS_PER_S)
        nbytes = n * (int((w * h).sum()) * 4 + B * P * P * 4 * 3) + B * 32
        if sdh is not None:             # the groups' slot tables
            nbytes += sdh[0] // n * 16 * 4
        if jccr is not None:            # the joint flag
            nbytes += B * 4
        if name == K6B[0]:
            nbytes += len(live) * (128 + 3) * 4
    elif name == "cclm":
        # the luma window (rows ly-2 .. ly+2h-1, columns lx-3 .. lx+2w-1), two
        # originals and two DM predictions in, four template samples per
        # plane, the order grid's two cells; two prediction tiles and a flag out
        nbytes = int(((2 * h + 2) * (2 * w + 3)).sum()) * 4 + int((w * h).sum()) * 4 * 4 + \
            len(live) * (2 * 4 * 4 + 2 * 4) + B * (2 * P * P * 4 + 4 + 32)
        ops = int((w * h).sum()) * (OPS_DOWNSAMPLE + 2 * OPS_LM + 4 * OPS_SATD)
    elif name == "tq_mts":
        int_ops, float_ops, groups = k5_ops(rows, P, k5)
        ops = int_ops + float_ops
        t_ops = max(int_ops / int32_ops_per_s(), float_ops / FP32_OPS_PER_S)
        nbytes = int((w * h).sum()) * 4 + B * P * P * 4 * 3 + B * (32 + 4 * 4) + \
            groups * 16 * 4
    else:                               # wave_scatter, up to four grids
        ops = 0
        nbytes = n * int((w * h).sum()) * (8 + 6) + B * 32 + \
            ngrids * (int((w // 4 * h // 4).sum()) + len(live) * 4)
    if name not in ("tq_mts", "tq", K6B[0]):
        t_ops = ops / ops_rate(name)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


K5_KINDS = ("DCT-2", "DST-7/DCT-8", "LFNST", "transform skip", "zero TU")


def k5_kinds(lev, tr, lf, rows) -> np.ndarray:
    """(5,) counts of the live CUs by the K5 candidate kind that won."""
    ok = (rows[:, 6] > 0).cpu().numpy()
    coded = (lev[0] != 0).flatten(1).any(1).cpu().numpy()
    tr, lf = tr.cpu().numpy(), lf.cpu().numpy()
    kind = np.where(~coded, 4, np.where(lf > 0, 2, np.where(tr == 1, 3,
                                                            np.where(tr >= 2, 1, 0))))
    return np.bincount(kind[ok], minlength=5)


def k5_inputs(orgs, rows, P: int, pred, noisy, best, codes, seed: int):
    """(name, originals, prediction, modes, MIP codes) sets for K5 beyond
    the K4 ones: residuals of sparse +-300 impulses (transform skip wins),
    and residuals that are one LFNST basis function each (the inverse DCT-2
    of the inverse LFNST of two secondary coefficients, for the CU's mode,
    idx 1 or 2; LFNST wins), with random modes and MIP codes."""
    rng = np.random.RandomState(seed)
    B = rows.shape[0]
    fi, xs, ys, ws, hs, _, _ = unpack_rows(rows, 1)
    d = torch.arange(P, device=rows.device, dtype=torch.int32)
    inside = (d[None, :, None] < hs[:, None, None]) & (d[None, None, :] < ws[:, None, None])
    tile = gather_plane(orgs[0], fi[:, None, None], ys[:, None, None] + d[None, :, None],
                        xs[:, None, None] + d[None, None, :])
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(rows.device)
    impulses = dev((rng.rand(B, P, P) < 0.03) * rng.choice([-300, 300], (B, P, P)))
    modes = dev(rng.randint(0, 67, B))
    mip = dev((rng.rand(B) < 0.3) * rng.randint(1, 33, B))
    sec = np.zeros((B, P, P), np.int32)
    sec[:, 0, 0] = rng.choice([-1, 1], B) * rng.randint(2000, 8000, B)
    sec[:, 1, 0] = rng.randint(-3000, 3000, B)
    sec = dev(sec)
    basis = torch.cat([inv_lfnst_generic(sec[b:b + 1], modes[b:b + 1], ws[b:b + 1],
                                         hs[b:b + 1], 1 + b % 2) for b in range(B)])
    basis = ttq.inverse_transform_generic(basis, ws, hs, bit_depth=BD) * inside
    return [("prediction", orgs, pred, best, codes),
            ("noisy", orgs, noisy, best, codes),
            ("full swing", [torch.full_like(orgs[0], 1023)], torch.zeros_like(pred), best,
             codes),
            ("impulses", orgs, (tile + impulses).clamp(0, 1023)[None].contiguous(), modes, mip),
            ("LFNST basis", orgs, (tile - basis).clamp(0, 1023)[None].int().contiguous(),
             modes, mip)]


def cclm_luma(rec_c: np.ndarray, seed: int) -> np.ndarray:
    """A luma recon for K6a's seeded inputs: the chroma recon ``rec_c`` (2
    frames) upsampled 2x with noise, so that LM fits the chroma; a flat
    64x64 block (flat templates) and a 64x64 block of values 500-502 under
    chroma of a wide range (slopes clamped to +-15)."""
    rng = np.random.RandomState(seed)
    up = np.repeat(np.repeat(rec_c, 2, 1), 2, 2)
    ry = up + rng.randint(-3, 4, up.shape)
    ry[:, 64:128, 128:192] = 600
    ry[:, 128:192, 64:128] = 500 + rng.randint(0, 3, (2, 64, 64))
    return ry.clip(0, 1023).astype(np.int32)


CCLM_CASES = ("left+above", "left only", "above only", "neither", "CTU top", "frame edge",
              "two samples", "flat", "clamped", "LM chosen", "DM better", "SATD tie",
              "LM better, gate off")


def cclm_cases(refs, ry, orgs, og, rows, pred, P: int, use) -> np.ndarray:
    """Counts of K6a's cases over the live rows of one call (``CCLM_CASES``,
    in that order), from the plain pieces and the call's ``use``."""
    fi, cxs, cys, cws, chs, _, ok = unpack_rows(rows, 2)
    la, aa = cclm_neighbours(og, rows)
    _, _, case = cclm_models(ry, fi, cxs, cys, cws, chs, pad_c=P, top_u=refs[0, 0],
                             left_u=refs[0, 1], top_v=refs[1, 0], left_v=refs[1, 1],
                             bit_depth=BD, left_avail=la, above_avail=aa)
    _, cost_dm, cost_lm = cclm_costs(refs, ry, orgs, og, rows, pred, P, BD)
    gate = (rows[:, 7] & 1) > 0
    Hc, Wc = orgs[0].shape[1:]
    masks = (la & aa, la & ~aa, ~la & aa, ~la & ~aa, aa & (2 * cys % 128 == 0),
             (cxs + cws == Wc) | (cys + chs == Hc), case["two"], case["flat"],
             case["clamped"][0] | case["clamped"][1], use > 0, cost_dm < cost_lm,
             cost_dm == cost_lm, ~gate & (cost_lm < cost_dm))
    return np.array([int((m & ok).sum()) for m in masks])


JCCR_CASES = ("joint won", "joint lost", "joint TU zero", "odd difference > 0",
              "odd difference < 0")


def jccr_cases(orgs, pred, rows, P: int, qp_j: int, lam: float, dw: float, sdh: bool,
               active, use) -> np.ndarray:
    """Counts of the joint Cb-Cr trial's cases over the live rows of one K4
    call (``JCCR_CASES``), from the plain pieces and the call's ``use``."""
    tiles = [ttq._orgs_inside(o, rows, P, 2) for o in orgs]
    (ou, inside, ws, hs, ok), (ov, *_) = tiles
    d = (ou - pred[0]) * inside - (ov - pred[1]) * inside
    joint = torch.round(d.double() / 2).int()
    act = None if active is None else active.bool()
    lev_j = ttq._tq_tile(pred[0] + joint, pred[0], inside, ws, hs, ok, qp_j, BD, True, lam,
                         dw, sdh, act)[0]
    cbf_j = (lev_j != 0).flatten(1).any(1)
    odd = (d % 2 != 0) & inside & ok[:, None, None]
    return np.array([int(((use > 0) & ok).sum()), int((cbf_j & (use == 0) & ok).sum()),
                     int((~cbf_j & ok).sum()), int((odd & (d > 0)).sum()),
                     int((odd & (d < 0)).sum())])


CRS_W, CRS_H = 208, 120               # VPDUs cut by the right and bottom edges
CRS_CASES = ("left+above", "left only", "above only", "neither", "cut by the right edge",
             "cut by the bottom edge", "<= 4 samples", "scale != 1 << 11")


def device_crs_lut() -> torch.Tensor:
    """The main path's CRS LUT (``crs_lut`` at its ``lmcs_offset``) on the card."""
    return torch.from_numpy(crs_lut(BD, enc_cfg(64, 64).lmcs_offset)).to(DEVICE)


def crs_kernel_rows(pad: int, seed: int, n: int = 40) -> np.ndarray:
    """(n + 2, 8) int32 rows of chroma CUs of the pad class (luma units:
    sides up to 2 * pad, and above 32 in the 32-pad class) at random 4-aligned
    positions of a CRS_W x CRS_H frame, random order ids, then two padding
    rows; in the 16-pad class the first four are 4x4 (2x2 chroma samples,
    which are not scaled)."""
    rng = np.random.RandomState(seed)
    sides = [s for s in (4, 8, 16, 32, 64) if s <= 2 * pad]
    sizes = [(w, h) for w, h in itertools.product(sides, sides) if pad == 16 or max(w, h) > 32]
    rows = []
    for i in range(n):
        w, h = (4, 4) if pad == 16 and i < 4 else sizes[rng.randint(len(sizes))]
        x = rng.randint(0, (CRS_W - w) // 4 + 1) * 4
        y = rng.randint(0, (CRS_H - h) // 4 + 1) * 4
        rows.append((rng.randint(2), x, y, w, h, rng.randint(0, 200), 1, 0))
    rows += [(0, 0, 0, 0, 0, 0, 0, 0)] * 2
    return np.array(rows, np.int32)


def crs_cases(og, rows, scale) -> np.ndarray:
    """Counts of ``CRS_CASES`` over the live rows of one K4 call, from the
    plain pieces and the call's scales."""
    left, above = (t.cpu().numpy() for t in crs_neighbours(og, rows))
    r = rows.cpu().numpy()
    ok = r[:, 6] > 0
    vx, vy = r[:, 1] // 64 * 64, r[:, 2] // 64 * 64
    masks = (left & above, left & ~above, ~left & above, ~left & ~above,
             vx + 64 > CRS_W, vy + 64 > CRS_H, (r[:, 3] // 2) * (r[:, 4] // 2) <= 4,
             scale.cpu().numpy() != UNIT_SCALE)
    return np.array([int((m & ok).sum()) for m in masks])


def crs_kernel_checks(P: int, qp: int, lam: float, lut, errs: dict) -> np.ndarray:
    """K4 with the chroma residual scale against its plain version on a
    CRS_W x CRS_H frame: U and V alone and with the joint Cb-Cr trial, with
    and without sign-data hiding, and once with the single-tree LFNST
    region; the scales K4 returns held to ``crs_scale_reference``. Returns
    the ``CRS_CASES`` counts."""
    rows_np = crs_kernel_rows(P, seed=P + qp)
    rec, org, _ = kernel_planes(P + qp + 1, CRS_W, CRS_H, 2)
    # order ids mostly below the rows' (0..199): most neighbours precede
    og = np.random.RandomState(P + qp).randint(-1, 120, (2, CRS_H // 4, CRS_W // 4)).astype(
        np.int32)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
    rows, og_t = dev(rows_np), dev(og)
    # a luma recon: the chroma one upsampled 2x, with noise
    up = np.repeat(np.repeat(rec, 2, 1), 2, 2)
    ry = dev((up + np.random.RandomState(qp).randint(-40, 41, up.shape)).clip(0, 1023)
             .astype(np.int32))
    orgs = [dev(org), dev(1023 - org)]
    fi, xs, ys, _, _, _, _ = unpack_rows(rows, 2)
    d = torch.arange(P, device=DEVICE, dtype=torch.int32)
    tile = lambda p: gather_plane(p, fi[:, None, None], ys[:, None, None] + d[None, :, None],
                                  xs[:, None, None] + d[None, None, :])
    noise = torch.from_numpy(np.random.RandomState(qp).randint(
        -60, 61, (2, len(rows_np), P, P)).astype(np.int32)).to(DEVICE)
    pred = (torch.stack([tile(dev(rec)), tile(dev(1023 - rec))]) + noise).clamp(0, 1023)
    pred = pred.int().contiguous()
    active = dev((np.arange(len(rows_np)) % 3 == 0).astype(np.int32))
    want = crs_scale_reference(ry, og_t, rows, lut, BD)
    seen = np.zeros(len(CRS_CASES), np.int64)
    for sdh, jccr, act in ((False, False, None), (True, False, None), (False, True, None),
                           (True, True, None), (True, True, active)):
        args = (orgs, pred, rows, P, 2, qp + 12, BD, True, lam, 1.2599, sdh, act, jccr, qp + 13)
        scale = torch.empty_like(rows[:, 0])
        got = tq(*args, crs_src=(ry, og_t, lut), crs_out=scale)
        _cmp(K6B[0], list(got) + [scale], list(tq_reference(*args, crs=want)) + [want], errs)
        seen += crs_cases(og_t, rows, scale)
    return seen


def phase_encode_kernels() -> tuple[dict, dict]:
    """K1/K2/K3/K4/K5/K6a/K7 against their plain versions on seeded inputs,
    then their times at the main path's batch shapes."""
    errs: dict = {}
    max_level = sdh_changed = mip_wins = mip_rows = region_cut = 0
    k5_won = np.zeros(5, np.int64)
    cclm_seen = np.zeros(len(CCLM_CASES), np.int64)
    jccr_seen = np.zeros(len(JCCR_CASES), np.int64)
    crs_seen = np.zeros(len(CRS_CASES), np.int64)
    ties_seen = np.zeros(len(RMD_TIE_CASES), np.int64)
    mip_ties_seen = np.zeros(len(MIP_TIE_CASES), np.int64)
    k5_ties_seen = np.zeros(len(K5_TIE_CASES), np.int64)
    cclm_ties_seen = np.zeros(len(CCLM_TIE_CASES), np.int64)
    k4_ties_seen = np.zeros(len(K4_TIE_CASES), np.int64)
    lut = device_crs_lut()
    width, height = 256, 192
    for (P, scale), qp in itertools.product(((32, 1), (64, 1), (16, 2), (32, 2)), (0, 22, 37)):
        rows_np = kernel_rows(P, scale, seed=P + qp, width=width, height=height)
        if scale == 2:                  # K6a's CCLM gate, random
            rows_np[:, 7] = np.random.RandomState(P + qp).randint(0, 2, len(rows_np))
        rec, org, og = kernel_planes(P + scale + qp, width, height, scale)
        dev = lambda a: torch.from_numpy(a).to(DEVICE)
        rows, og_t = dev(rows_np), dev(og)
        n = 1 if scale == 1 else 2
        recs = [dev(rec), dev(rec[::-1].copy())][:n]
        orgs = [dev(org), dev(org[::-1].copy())][:n]
        mg = torch.from_numpy(np.random.RandomState(qp).randint(
            0, 67, (2, height // 4, width // 4)).astype(np.uint8)).to(DEVICE)
        refs = ref_gather(recs, og_t, rows, P, scale, BD)
        _cmp("ref_gather", refs, ref_gather_reference(recs, og_t, rows, P, scale, BD), errs)
        luma = scale == 1
        lam = 0.57 * 2 ** ((qp - 12) / 3)
        modes, pred = intra_rmd(refs, orgs[0] if luma else None, mg, rows, P, luma, BD)
        _cmp("intra_rmd", [modes, pred], list(intra_rmd_reference(
            refs, orgs[0] if luma else None, mg, rows, P, luma, BD)), errs)
        noise = np.random.RandomState(qp).randint(-300, 301, tuple(pred.shape))
        noisy = (pred + torch.from_numpy(noise.astype(np.int32)).to(DEVICE)).clamp(0, 1023)
        active = dev(np.random.RandomState(qp).randint(0, 3, len(rows_np)).astype(np.int32)
                     * (np.arange(len(rows_np)) % 3 == 0))
        grids = []
        if luma:
            ties_seen += rmd_tie_checks(P, seed=P + qp, errs=errs)
            mip_ties_seen += mip_tie_checks(P, seed=P + qp, errs=errs)
            k5_ties_seen += k5_tie_checks(P, seed=P + qp, errs=errs)
            args = (refs, orgs[0], rows, pred, modes, P, BD)
            best, pred3, codes = mip_select(*args)
            _cmp("mip_rmd", [best, pred3, codes], list(mip_select_reference(*args)), errs)
            mip_wins += int((codes > 0).sum())
            mip_rows += int((rows[:, 6] > 0).sum())
            # K5 with this slice's tools (MTS and transform skip in the
            # 32-pad class only) and sign-data hiding; on the noisy set also
            # MTS alone, LFNST alone without SDH and without the MIP gate,
            # and transform skip alone
            small = P <= 32
            main = (small, True, 32 if small else 0, True, True)
            alone = [(small, False, 0, True, True), (False, True, 0, False, False),
                     (False, False, 32 if small else 0, False, True)]
            for name, o, p, m, c in k5_inputs(orgs, rows, P, pred3, noisy.contiguous(),
                                               best, codes, seed=P + qp):
                for mts, lfnst, ts_max, sdh, gate in [main] + (alone if name == "noisy" else []):
                    args = (o, p, rows, P, qp + 12, BD, True, lam, m, c if gate else None,
                            mts, lfnst, ts_max, sdh)
                    got = tq_mts(*args)
                    _cmp("tq_mts", list(got), list(tq_mts_reference(*args)), errs)
                    if (mts, lfnst, ts_max, sdh, gate) == main:
                        k5_won += k5_kinds(got[0], got[2], got[3], rows)
                        tr, lf = got[2], got[3]
            grids = [(torch.zeros_like(mg), best), (torch.zeros_like(mg), codes),
                     (torch.zeros_like(mg), tr), (torch.zeros_like(mg), lf)]
        else:
            # every mode through the DM predictor on every CU size: the rows
            # repeated once per mode, row copy m reading mode grid frame m
            rows67 = np.tile(rows_np, (67, 1))
            rows67[:, 0] = np.repeat(np.arange(67), len(rows_np))
            rows67 = dev(rows67)
            mg67 = torch.arange(67, dtype=torch.uint8, device=DEVICE)[:, None, None] \
                .expand(67, height // 4, width // 4).contiguous()
            refs67 = refs.repeat(1, 1, 67, 1).contiguous()
            got = intra_rmd(refs67, None, mg67, rows67, P, False, BD)
            _cmp("intra_rmd", list(got), list(intra_rmd_reference(
                refs67, None, mg67, rows67, P, False, BD)), errs)
            check(set(got[0][rows67[:, 6] > 0].tolist()) == set(range(67)),
                  "the DM sweep did not reach every mode")
            # K6a, and K4's joint Cb-Cr trial after it: V = 1023 - U (recon
            # and original), so that V's residuals mirror U's; the luma recon
            # follows the U recon (``cclm_luma``)
            recs_c, orgs_c = [dev(rec), dev(1023 - rec)], [dev(org), dev(1023 - org)]
            ry = dev(cclm_luma(rec, seed=P + qp))
            refs_c = ref_gather(recs_c, og_t, rows, P, 2, BD)
            _cmp("ref_gather", refs_c, ref_gather_reference(recs_c, og_t, rows, P, 2, BD), errs)
            _, dm = intra_rmd(refs_c, None, mg, rows, P, False, BD)
            _cmp("intra_rmd", dm, intra_rmd_reference(refs_c, None, mg, rows, P, False, BD)[1],
                 errs)
            args = (refs_c, ry, orgs_c, og_t, rows, dm, P, BD)
            pred6, use_lm = cclm_select(*args)
            _cmp("cclm", [pred6, use_lm], list(cclm_select_reference(*args)), errs)
            cclm_seen += cclm_cases(*args[:7], use_lm)
            # an exact SATD tie on every third CU: its DM prediction is LM's
            tie = (torch.arange(len(rows_np), device=DEVICE) % 3 == 0)[None, :, None, None]
            args = (*args[:5], torch.where(tie, cclm_costs(*args)[0], dm).contiguous(), P, BD)
            got = cclm_select(*args)
            _cmp("cclm", list(got), list(cclm_select_reference(*args)), errs)
            cclm_seen += cclm_cases(*args[:7], got[1])
            cclm_ties_seen += cclm_tie_checks(P, seed=P + qp, errs=errs)
            if qp == 22:                # K4's tie cases, once a class
                k4_ties_seen += k4_tie_checks(P, seed=P, errs=errs)
            qp_j = qp + 13              # a joint QP of its own
            for (o, p), sdh, act in itertools.product(
                    ((orgs_c, pred6), (orgs, pred)), (False, True), (None, active)):
                args = (o, p, rows, P, 2, qp + 12, BD, True, lam, 1.2599, sdh, act, True, qp_j)
                got = tq(*args)
                _cmp("tq", list(got), list(tq_reference(*args)), errs)
                jccr_seen += jccr_cases(o, p, rows, P, qp_j, lam, 1.2599, sdh, act, got[2])
            grids = [(torch.zeros_like(mg), use_lm + 2 * got[2])]
            crs_seen += crs_kernel_checks(P, qp, lam, lut, errs)
        # the predictions, noisy ones, and full-swing residuals (original
        # 1023 against a zero prediction) for the largest levels; the DCT-2
        # TQ (luma: K5 with its tools off; chroma: K4) with sign-data hiding
        # off and on, and for chroma with the single-tree LFNST region on a
        # random third of the CUs
        flat = [torch.full_like(o, 1023) for o in orgs]
        for o, p in ((orgs, pred), (orgs, noisy.contiguous()), (flat, torch.zeros_like(pred))):
            if luma:
                args = (o, p, rows, P, qp + 12, BD, True, lam, modes)
                kernel, plain, name = (lambda *a, sdh=False: tq_mts(*a, sdh=sdh)[:2],
                                       lambda *a, sdh=False: tq_mts_reference(*a, sdh=sdh)[:2],
                                       "tq_mts")
            else:
                args = (o, p, rows, P, scale, qp + 12, BD, True, lam, 1.2599)
                kernel, plain, name = tq, tq_reference, "tq"
            lev0, rc0 = kernel(*args)
            _cmp(name, [lev0, rc0], list(plain(*args)), errs)
            lev, rc = kernel(*args, sdh=True)
            _cmp(name, [lev, rc], list(plain(*args, sdh=True)), errs)
            max_level = max(max_level, int(lev.abs().max()))
            sdh_changed += int((lev != lev0).sum())
            if not luma:
                levr, rcr = tq(*args, True, active)
                _cmp("tq", [levr, rcr], list(tq_reference(*args, True, active)), errs)
                region_cut += int(((levr == 0) & (lev != 0)).sum())
        state = [(torch.zeros_like(r), torch.zeros(r.shape, dtype=torch.int16, device=DEVICE))
                 for r in recs]
        scatter_both(rows, P, scale, state, rc, lev, grids, errs)
    # K6a's and K4's tie cases in the RDO's 4-pad chroma class too
    cclm_ties_seen += cclm_tie_checks(4, seed=4, errs=errs)
    k4_ties_seen += k4_tie_checks(4, seed=4, errs=errs)
    k1_edges, k7_edges = k1_edge_checks(errs), k7_edge_checks(errs)
    edge_cases_reached("K1", K1_EDGE_CASES, k1_edges)
    edge_cases_reached("K7", K7_EDGE_CASES, k7_edges)
    check(sdh_changed > 0, "sign-data hiding changed no level of the seeded inputs")
    check(0 < mip_wins < mip_rows, f"MIP won {mip_wins} of {mip_rows} CUs")
    check(region_cut > 0, "the LFNST region removed no chroma level")
    check((k5_won > 0).all(), f"some K5 candidate kind never won: {k5_won}")
    check((cclm_seen > 0).all(), f"some K6a case never occurred: {cclm_seen}")
    check((jccr_seen > 0).all(), f"some joint Cb-Cr case never occurred: {jccr_seen}")
    check((crs_seen > 0).all(), f"some chroma residual scaling case never occurred: {crs_seen}")
    check((ties_seen > 0).all(), f"some K2 tie case never occurred: {ties_seen}")
    check((mip_ties_seen > 0).all(), f"some K3 tie case never occurred: {mip_ties_seen}")
    check((k5_ties_seen > 0).all(), f"some K5 tie case never occurred: {k5_ties_seen}")
    check((cclm_ties_seen > 0).all(), f"some K6a tie case never occurred: {cclm_ties_seen}")
    check((k4_ties_seen > 0).all(), f"some K4 tie case never occurred: {k4_ties_seen}")
    log(f"[encode-kernels] K1/K2/K3/K4 (with K6b, K6c)/K5/K6a/K7 equal to their plain "
        f"versions on every "
        f"CU size of both classes, luma and chroma, QP 0/22/37 (max_abs_err {errs}); "
        f"largest |level| {max_level}; K3 chose MIP for {mip_wins} of {mip_rows} CUs; "
        f"sign-data hiding changed {sdh_changed} levels; the LFNST region removed "
        f"{region_cut} chroma levels; K5 winners with all tools: "
        + ", ".join(f"{k} {int(c)}" for k, c in zip(K5_KINDS, k5_won))
        + "; K6a cases: " + ", ".join(f"{k} {int(c)}" for k, c in zip(CCLM_CASES, cclm_seen))
        + "; joint Cb-Cr cases: "
        + ", ".join(f"{k} {int(c)}" for k, c in zip(JCCR_CASES, jccr_seen))
        + "; K6b cases: " + ", ".join(f"{k} {int(c)}" for k, c in zip(CRS_CASES, crs_seen))
        + "; K2 tie cases: " + ", ".join(f"{k} {int(c)}" for k, c in zip(RMD_TIE_CASES,
                                                                         ties_seen))
        + "; K3 tie cases: " + ", ".join(f"{k} {int(c)}" for k, c in zip(MIP_TIE_CASES,
                                                                         mip_ties_seen))
        + "; K5 tie cases: " + ", ".join(f"{k} {int(c)}" for k, c in zip(K5_TIE_CASES,
                                                                         k5_ties_seen))
        + "; K6a tie cases: " + ", ".join(f"{k} {int(c)}" for k, c in zip(CCLM_TIE_CASES,
                                                                          cclm_ties_seen))
        + "; K4 tie cases: " + ", ".join(f"{k} {int(c)}" for k, c in zip(K4_TIE_CASES,
                                                                         k4_ties_seen))
        + "; K1 edge cases (every class): "
        + ", ".join(f"{k} {int(c)}" for k, c in zip(K1_EDGE_CASES, sum(k1_edges.values())))
        + "; K7 edge cases (every class, 0 to 4 grids): "
        + ", ".join(f"{k} {int(c)}" for k, c in zip(K7_EDGE_CASES, sum(k7_edges.values()))))
    return errs, phase_encode_kernel_times(width, height)


# (pad, scale, CUs): each tile class at the main path's batch (DEFAULT_BATCH)
TIMED_CLASSES = ((32, 1, 16), (64, 1, 8), (16, 2, 16), (32, 2, 8))


def phase_encode_kernel_times(width: int, height: int) -> dict:
    """Each kernel's device time, plain time and bound at the main path's
    batch shapes: each tile class at its batch (DEFAULT_BATCH), the main
    path's tools. The JSON line carries each kernel at the class of the main
    path's most numerous steps that run it: the 32-pad luma class, and for
    K4 and K6a the 16-pad chroma class. K4 is also timed without the joint
    Cb-Cr trial, with and without sign-data hiding, and K5 with its tools off
    (the luma TQ of the configurations without them), with and without
    sign-data hiding. The chroma planes are V = 1023 - U, and the luma recon
    follows U (``cclm_luma``), so that LM and the joint trial win on some
    CUs; every chroma row has the CCLM gate set."""
    times = {}
    launch_floor_times("[encode-kernels]")
    for P, scale, B in TIMED_CLASSES:
        luma = scale == 1
        rows_np = kernel_rows(P, scale, seed=1, width=width, height=height)[:B]
        rows_np[:, 7] = 0 if luma else 1
        rec, org, og = kernel_planes(1, width, height, scale)
        n = 1 if luma else 2
        rows, og_t = torch.from_numpy(rows_np).to(DEVICE), torch.from_numpy(og).to(DEVICE)
        recs = [torch.from_numpy(r).to(DEVICE) for r in (rec, 1023 - rec)[:n]]
        orgs = [torch.from_numpy(o).to(DEVICE) for o in (org, 1023 - org)[:n]]
        levs = [torch.zeros(r.shape, dtype=torch.int16, device=DEVICE) for r in recs]
        mg = torch.from_numpy(np.random.RandomState(2).randint(
            0, 67, (2, height // 4, width // 4)).astype(np.uint8)).to(DEVICE)
        pg, tg, lg = (torch.zeros_like(mg) for _ in range(3))
        org0 = orgs[0] if luma else None
        refs = ref_gather(recs, og_t, rows, P, scale, BD)
        modes, pred = intra_rmd(refs, org0, mg, rows, P, luma, BD)
        lam = 0.57 * 2 ** ((ENC_QP - 12) / 3)
        calls = {
            "ref_gather": (lambda: ref_gather(recs, og_t, rows, P, scale, BD),
                           lambda: ref_gather_reference(recs, og_t, rows, P, scale, BD)),
            "intra_rmd": (lambda: intra_rmd(refs, org0, mg, rows, P, luma, BD),
                          lambda: intra_rmd_reference(refs, org0, mg, rows, P, luma, BD)),
        }
        extra = {"intra_rmd": dict(modes=modes.cpu().numpy() if luma else None)}
        k5_out = {}
        if luma:
            k3_args = (refs, org0, rows, pred, modes, P, BD)
            best, pred, codes = mip_select(*k3_args)
            small = P <= 32
            gate = ttq.lfnst_gate(codes, rows[:, 3], rows[:, 4]).cpu().numpy()
            calls["mip_rmd"] = (lambda: mip_select(*k3_args),
                                lambda: mip_select_reference(*k3_args))
            extra["mip_rmd"] = dict(codes=codes.cpu().numpy())
            # this slice's tools, then none (with and without sign-data hiding)
            for name, tools in (("tq_mts", (small, True, 32 if small else 0, True)),
                                ("tq_mts_no_tools", (False, False, 0, True)),
                                ("tq_mts_no_tools_no_sdh", (False, False, 0, False))):
                args = (orgs, pred, rows, P, ENC_QP + 12, BD, True, lam, best, codes, *tools)
                k5_out[name] = tq_mts(*args)
                legal = torch.stack([torch.isfinite(c[2]) for c in
                                     tq_mts_candidates(*args)[0]], 1).cpu().numpy()
                calls[name] = (lambda a=args: tq_mts(*a), lambda a=args: tq_mts_reference(*a))
                extra[name] = dict(k5=(*tools, legal, gate))
            lev, rc, tr, lf = k5_out["tq_mts"]
            grids = [(mg, best), (pg, codes), (tg, tr), (lg, lf)]
        else:
            ry = torch.from_numpy(cclm_luma(rec, 1)).to(DEVICE)
            k6_args = (refs, ry, orgs, og_t, rows, pred, P, BD)
            pred, use_lm = cclm_select(*k6_args)
            calls["cclm"] = (lambda: cclm_select(*k6_args),
                             lambda: cclm_select_reference(*k6_args))
            # the main path's K4 (sign-data hiding and the joint Cb-Cr trial
            # at the joint QP, which equals the chroma QP without offsets),
            # then without the trial, with and without sign-data hiding
            qp_c = ENC_QP + 12
            tq_args = (orgs, pred, rows, P, scale, qp_c, BD, True, lam, 1.2599)
            lev, rc, joint = tq(*tq_args, sdh=True, jccr=True, qp_j=qp_c)
            calls["tq"] = (lambda: tq(*tq_args, sdh=True, jccr=True, qp_j=qp_c),
                           lambda: tq_reference(*tq_args, sdh=True, jccr=True, qp_j=qp_c))
            calls["tq_no_jccr"] = (lambda: tq(*tq_args, sdh=True),
                                   lambda: tq_reference(*tq_args, sdh=True))
            calls["tq_no_jccr_no_sdh"] = (lambda: tq(*tq_args), lambda: tq_reference(*tq_args))
            # and with the chroma residual scale (K6b), the LMCS main path's
            # K4: the plain version derives the scales too
            crs_src = (ry, og_t, device_crs_lut())
            kw_main = dict(sdh=True, jccr=True, qp_j=qp_c)
            calls[K6B[0]] = (
                lambda: tq(*tq_args, **kw_main, crs_src=crs_src),
                lambda: tq_reference(*tq_args, **kw_main,
                                     crs=crs_scale_reference(*crs_src[:2], rows, crs_src[2], BD)))
            sdh = sdh_groups(resid_tiles(orgs, pred, rows, P, scale), rows, P, scale, qp_c, lam)
            extra["tq"] = dict(sdh=sdh, jccr=sdh_groups(
                resid_tiles(orgs, pred, rows, P, scale, joint=True), rows, P, scale, qp_c, lam))
            crs = crs_scale_reference(*crs_src[:2], rows, crs_src[2], BD)
            scaled = lambda res: [crs_forward(r, crs, BD) for r in res]
            extra[K6B[0]] = dict(
                sdh=sdh_groups(scaled(resid_tiles(orgs, pred, rows, P, scale)), rows, P, scale,
                               qp_c, lam),
                jccr=sdh_groups(scaled(resid_tiles(orgs, pred, rows, P, scale, joint=True)),
                                rows, P, scale, qp_c, lam))
            extra["tq_no_jccr"] = dict(sdh=sdh)
            grids = [(pg, use_lm + 2 * joint)]
        planes = list(zip(recs, levs))
        calls["wave_scatter"] = (
            lambda: wf.wave_scatter(rows, P, scale, planes, rc, lev, grids),
            lambda: wf.wave_scatter_reference(rows, P, scale, planes, rc, lev, grids))
        extra["wave_scatter"] = dict(ngrids=len(grids))
        for name, (kernel, plain) in calls.items():
            bound, by, nbytes, ops = kernel_bounds(name.split("_no_")[0], rows_np,
                                                   P, scale, n, **extra.get(name, {}))
            ms, call = graph_ms(kernel), call_ms(kernel, 500)
            plain_ms = call_ms(plain, 20)
            if (P, scale) == ((16, 2) if name in ("tq", K6B[0], "cclm") else (32, 1)):
                times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
            log(f"[encode-kernels] {name}: {B} CUs, {P}-pad {'luma' if luma else 'chroma'}: "
                f"device time per call (CUDA graph) {ms:.6f} ms; called from Python "
                f"{call:.6f} ms; plain version from Python {plain_ms:.6f} ms; bound "
                f"{bound:.6f} ms by {by} ({nbytes} B, {ops} ops)"
                + (f"; sign-data hiding corrects {extra['tq']['sdh'][1]} of "
                   f"{extra['tq']['sdh'][0]} groups; the joint TU wins on "
                   f"{int(joint.sum())} CUs" if name == "tq" else "")
                + (f"; LM chosen for {int(use_lm.sum())} CUs" if name == "cclm" else "")
                + (f"; winners {k5_kinds(*k5_out[name][::2], k5_out[name][3], rows).tolist()}"
                   if name in k5_out else ""))
    return times


def frame_maps(preds: dict, frames, w: int, h: int):
    """Per-frame (luma maps, chroma maps) from the port's Luma and Chroma
    QP22 predictors on the >>2 8-bit planes, as bench.py's _frame_maps."""
    y8, u8, v8 = (np.stack([(f[i] >> 2).astype(np.uint8) for f in frames])
                  for i in range(3))
    lin, cin = blocks_for_sequence(y8, u8, v8)
    nblk = lin.shape[0] // len(frames)
    out = {}
    for comp, blocks in (("Luma", lin), ("Chroma", cin)):
        out[comp] = []
        for i in range(len(frames)):
            qt, bt, dire = preds[(comp, ENC_QP)].predict(blocks[i * nblk:(i + 1) * nblk])
            out[comp].append(blocks_to_frame_partition(qt, bt, dire, w, h, comp == "Luma"))
    return out["Luma"], out["Chroma"]


def stream_of(outs) -> tuple:
    """(the frames' bitstreams joined, their recons) of ``encode_frame`` /
    ``encode_frames`` outputs."""
    return b"".join(bs for bs, _ in outs), [recon for _, recon in outs]


def sei_md5s(bitstream: bytes) -> list[bytes]:
    """The three MD5 digests of each decoded-picture-hash suffix SEI."""
    digests = []
    for nal in bitstream.split(b"\x00\x00\x00\x01")[1:]:
        if (nal[1] >> 3) & 0x1F != 24:        # suffix SEI
            continue
        rbsp = nal[2:].replace(b"\x00\x00\x03", b"\x00\x00")
        check(rbsp[0] == 132 and rbsp[2] == 0, "SEI is not an MD5 picture hash")
        digests.append([rbsp[3 + 16 * i:19 + 16 * i] for i in range(3)])
    return digests


def reset_counts() -> None:
    for fn, _, _ in ENC_KERNELS.values():
        fn.launches = 0
    tq.crs_launches = 0
    reset_rdo_counts()


def timed_encode(enc, frames, maps_l, maps_c, label: str):
    """One warm ``encode_frames`` run: its outputs, stage times logged."""
    enc.timings = {}
    t0 = time.perf_counter()
    outs = enc.encode_frames(frames, maps=maps_l, chroma_maps=maps_c)
    wall = time.perf_counter() - t0
    stages = ", ".join(f"{k} {v:.3f}" for k, v in enc.timings.items())
    log(f"[encode] {label}: warm run {wall:.3f} s = {len(frames) / wall:.4f} frames/s "
        f"({stages} s)")
    return outs


def luma_codes(enc, maps_l, maps_c, frames: int) -> dict:
    """Counts over the luma leaves of the last encode: all, MIP, MTS
    (mts_idx 2..5), LFNST, transform skip, from the returned code grids."""
    tg, pg, lg = (enc._dev_result[k] for k in (7, 8, 10))
    out = dict(cus=0, mip=0, mts=0, lfnst=0, ts=0)
    for f in range(frames):
        for x, y, *_ in enc._collect_all(None, maps_l[f], maps_c[f])[0]:
            r, c = y // 4, x // 4
            out["cus"] += 1
            out["mip"] += int(pg[f, r, c] > 0)
            out["mts"] += int(tg[f, r, c] >= 2)
            out["lfnst"] += int(lg[f, r, c] > 0)
            out["ts"] += int(tg[f, r, c] == 1)
    return out


def chroma_codes(enc, maps_l, maps_c, frames: int) -> dict:
    """Counts over the chroma CUs of the last encode (the chroma tree's
    leaves in dual tree, the CUs in single tree): all, LM, joint Cb-Cr TUs,
    from the returned code grid."""
    cg = enc._dev_result[9]
    out = dict(cus=0, lm=0, joint=0)
    for f in range(frames):
        leaves, cleaves = enc._collect_all(None, maps_l[f], maps_c[f])
        for x, y, *_ in leaves if cleaves is None else cleaves:
            code = int(cg[f, y // 4, x // 4])
            out["cus"] += 1
            out["lm"] += code & 1
            out["joint"] += code >> 1 & 1
    return out


def chroma_tool_frames(w: int, h: int, n: int, seed0: int = 3) -> list:
    """n seeded 10-bit (y, u, v) frames where LM and the joint Cb-Cr trial
    win: a textured luma; on the left half chroma anti-correlated between U
    and V (as the JAX package's joint Cb-Cr test has it), on the right half
    chroma linear in the 2x2-averaged luma."""
    out = []
    for f in range(n):
        rng = np.random.RandomState(seed0 + f)
        yy, xx = np.mgrid[0:h, 0:w]
        y = np.clip(128 + 60 * np.sin(xx / 13.) * np.cos(yy / 17.) + rng.randn(h, w) * 8,
                    0, 255).astype(np.int32) << 2
        base = 30 * np.sin(xx[::2, ::2] / 9.) + rng.randn(h // 2, w // 2) * 6
        u = np.clip(128 + base, 0, 255).astype(np.int32) << 2
        v = np.clip(128 - base, 0, 255).astype(np.int32) << 2
        ds = (y[0::2, 0::2] + y[1::2, 0::2] + y[0::2, 1::2] + y[1::2, 1::2] + 2) >> 2
        right = np.s_[:, w // 4:]
        u[right] = np.clip(160 + ds[right] // 2, 0, 1023)
        v[right] = np.clip(1000 - (3 * ds[right]) // 4, 0, 1023)
        out.append((y, u, v))
    return out


def phase_encode(preds: dict):
    """The map-driven encode at 1920x1080: the LMCS slice's configuration
    (MIP, SDH, MTS, LFNST, TS, CCLM, JCCR, LMCS with chroma scaling) and the
    one before it (without LMCS), a cold run of one frame each, then one
    warm run of both frames of each, old then new; the new one is the main
    path's, with every kernel's launches counted (K4's with the chroma scale
    apart)."""
    frames = natural_sequence(ENC_W, ENC_H, ENC_FRAMES, seed0=7, bit_depth=BD)
    t0 = time.perf_counter()
    maps_l, maps_c = frame_maps(preds, frames, ENC_W, ENC_H)
    log(f"[encode] maps for {ENC_FRAMES} frames in {time.perf_counter() - t0:.3f} s")
    encs = {tools: wf.WavefrontEncoder(enc_cfg(ENC_W, ENC_H, tools), accel_level=3,
                                       device=DEVICE) for tools in (PREVIOUS, MAIN)}
    for tools, enc in encs.items():           # one frame loads every kernel
        t0 = time.perf_counter()
        enc.encode_frames(frames[:1], maps=maps_l[:1], chroma_maps=maps_c[:1])
        log(f"[encode] {tools}: cold run (1 frame) {time.perf_counter() - t0:.3f} s")
    enc = encs[MAIN]
    timed_encode(encs[PREVIOUS], frames, maps_l, maps_c, PREVIOUS)
    reset_counts()
    outs = timed_encode(enc, frames, maps_l, maps_c, f"{MAIN}, the main path")
    launches = {name: fn.launches for name, (fn, _, _) in ENC_KERNELS.items()}
    launches[K6B[0]] = tq.crs_launches
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the encode path")
    check(tq.crs_launches == tq.launches, "K4 ran without the chroma scale on the LMCS path")
    codes = luma_codes(enc, maps_l, maps_c, ENC_FRAMES)
    for tool in ("mip", "mts", "lfnst"):
        check(codes[tool] > 0, f"no CU of the encode was coded with {tool}")
    cc = chroma_codes(enc, maps_l, maps_c, ENC_FRAMES)
    log(f"[encode] {ENC_W}x{ENC_H} x {ENC_FRAMES} frames, QP {ENC_QP}, dual tree, "
        f"{MAIN}: {enc.steps} wave steps; launches {launches}; of {codes['cus']} luma "
        f"CUs, {codes['mip']} coded with MIP, {codes['mts']} with DST-7/DCT-8, "
        f"{codes['lfnst']} with LFNST, {codes['ts']} with transform skip; of "
        f"{cc['cus']} chroma CUs, {cc['lm']} coded with LM, {cc['joint']} with a joint "
        f"Cb-Cr TU")
    nbytes = 0
    for f, (bs, recon) in enumerate(outs):
        nbytes += len(bs)
        want = [hashlib.md5(p.astype("<u2").tobytes()).digest() for p in recon]
        check(sei_md5s(bs) == [want], f"frame {f}: hash SEI differs from the recon's MD5")
        err = (recon[0].astype(np.int64) - frames[f][0]) ** 2
        psnr = 10 * np.log10(1023 * 1023 / err.mean())
        check(psnr > 30, f"frame {f}: luma PSNR {psnr:.2f} dB")
        log(f"[encode] frame {f}: {len(bs)} bytes, luma PSNR {psnr:.3f} dB, "
            f"hash SEI equal to the recon's MD5")
    log(f"[encode] {nbytes * 8 / ENC_FRAMES / 1e6:.4f} Mbit per frame")
    return enc, frames, maps_l, maps_c, launches


def phase_encode_first_steps(frames, maps_l, maps_c, n_steps: int = 48,
                             n_chroma: int = 16) -> dict:
    """Every kernel against its plain version on the real schedule rows of
    the main path's first ``n_steps`` wave steps, and of its first
    ``n_chroma`` steps with chroma rows (the dual tree's chroma levels follow
    a frame's luma levels, so the steps between run the kernels unchecked),
    the kernels' results carrying the state from step to step."""
    enc = wf.WavefrontEncoder(enc_cfg(ENC_W, ENC_H), accel_level=3, device=DEVICE)
    leaves = [enc._collect_all(None, maps_l[f], maps_c[f]) for f in range(len(frames))]
    active, step_arr, ogs, ogcs = wf._pack_schedule(leaves, ENC_W, ENC_H, enc.batch,
                                                    enc.cfg.cclm, enc.crs_lut is not None)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(DEVICE)
    F, H, W = len(frames), ENC_H, ENC_W
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=DEVICE)
    state = [z((F, H, W), torch.int32), z((F, H // 2, W // 2), torch.int32),
             z((F, H // 2, W // 2), torch.int32), z((F, H, W), torch.int16),
             z((F, H // 2, W // 2), torch.int16), z((F, H // 2, W // 2), torch.int16)] + \
        [z((F, H // 4, W // 4), torch.uint8) for _ in range(5)]
    qp_y, qp_c, qp_j = enc._qps()
    cfg = enc.cfg
    # the luma coded in the mapped domain, as _batched_pass uploads it
    luma = np.stack([enc.reshaper.fwd(fr[0]) for fr in frames])
    scan = wf._Scan(state, up(luma), *(up(np.stack([fr[i] for fr in frames])) for i in (1, 2)),
                    up(ogs), up(ogcs), qp_y, qp_c, BD, float(enc.lam), float(enc.dw_c), True,
                    mip=cfg.mip, sdh=cfg.sign_hiding, mts=cfg.mts_intra, lfnst=cfg.lfnst,
                    ts_max=(1 << cfg.ts_max_log2) if cfg.transform_skip else 0,
                    cclm=cfg.cclm, jccr=cfg.joint_cbcr, qp_j=qp_j, crs_lut=up(enc.crs_lut))
    errs: dict = {}
    rows = checked = chroma_checked = 0
    for t in range(next(iter(step_arr.values())).shape[0]):
        live = [(kind, P) for kind, P in active if step_arr[(kind, P)][t][:, 6].any()]
        chroma = any(kind == "chroma" for kind, _ in live)
        check_t = t < n_steps or (chroma and chroma_checked < n_chroma)
        for kind, P in live:
            arr = step_arr[(kind, P)][t]
            if check_t:
                checked_step(scan, kind, P, up(arr), errs)
                rows += int(arr[:, 6].sum())
            else:
                scan.step(kind, P, up(arr))
        checked += check_t
        chroma_checked += check_t and chroma
        if t >= n_steps and chroma_checked >= n_chroma:
            break
    # the main path's K4 runs with the chroma scale
    want = set(ENC_KERNELS) - {"tq"} | {K6B[0]}
    check(want <= set(errs), f"kernels not run on the first steps: {want - set(errs)}")
    log(f"[first-steps] the main path's first {n_steps} wave steps and first {n_chroma} "
        f"with chroma rows ({checked} steps, {rows} CU rows): every kernel equal to its "
        f"plain version (max_abs_err {errs})")
    return errs


def phase_encode_bench_tools(preds: dict) -> tuple:
    """The bench's configuration at 416x240 x 2 frames of natural content with
    the QP 22 maps (the only QP with chroma checkpoints): a cold run, then a
    warm one with its stage times; hash SEI against the recon's MD5, some CTU
    with luma ALF on, and the CTUs with each ALF and CC-ALF filter on.
    Returns the warm run's (stream, recons)."""
    frames = natural_sequence(SMALL_W, SMALL_H, 2, seed0=7, bit_depth=BD)
    maps_l, maps_c = frame_maps(preds, frames, SMALL_W, SMALL_H)
    enc = wf.WavefrontEncoder(enc_cfg(SMALL_W, SMALL_H, BENCH), accel_level=3, device=DEVICE)
    t0 = time.perf_counter()
    enc.encode_frames(frames, maps=maps_l, chroma_maps=maps_c)
    log(f"[bench-tools] {SMALL_W}x{SMALL_H} x 2, {BENCH}: cold run "
        f"{time.perf_counter() - t0:.3f} s")
    enc.alf_ctus = {}
    outs = timed_encode(enc, frames, maps_l, maps_c, f"{BENCH} at {SMALL_W}x{SMALL_H}")
    alf_ctus = enc.alf_ctus
    for f, (bs, recon) in enumerate(outs):
        want = [hashlib.md5(p.astype("<u2").tobytes()).digest() for p in recon]
        check(sei_md5s(bs) == [want], f"frame {f}: hash SEI differs from the recon's MD5")
    check(alf_ctus["luma"] > 0, f"no CTU with luma ALF on: {alf_ctus}")
    log(f"[bench-tools] {[len(o[0]) for o in outs]} bytes, {enc.steps} wave steps; CTUs "
        f"with each ALF filter over both frames {alf_ctus}; hash SEI equal to the recon's "
        f"MD5")
    return stream_of(outs)


# Phase 10's encodes, CPU against card: (tools, dual tree, width, height,
# content); the oldest at a quarter of 416x240, which keeps the plain
# versions' CPU time down, the CCLM and joint Cb-Cr slice's in both trees on
# content where LM and the joint Cb-Cr trial win, and the bench's tools in
# dual tree on natural content and in single tree on that chroma content at
# 208x120, whose VPDUs both frame edges cut.
CPU_VS_CARD = (
    ("no tools", True, SMALL_W // 2, SMALL_H // 2, "natural"),
    ("MIP + SDH", True, SMALL_W, SMALL_H, "natural"),
    ("MIP + SDH + MTS + LFNST + TS", True, SMALL_W, SMALL_H, "natural"),
    (PREVIOUS, True, SMALL_W, SMALL_H, "chroma tools"),
    (PREVIOUS, False, SMALL_W // 2, SMALL_H // 2, "chroma tools"),
    (BENCH, True, SMALL_W, SMALL_H, "natural"),
    (BENCH, False, SMALL_W // 2, SMALL_H // 2, "chroma tools"),
)


def phase_encode_cpu_vs_card(preds: dict) -> None:
    """Two frames of each ``CPU_VS_CARD`` encode on the CPU and on the card:
    the bitstreams must be byte-identical, and on the chroma-tools content
    both LM and the joint Cb-Cr trial must win somewhere."""
    for tools, dual, w, h, content in CPU_VS_CARD:
        frames = natural_sequence(w, h, 2, seed0=7, bit_depth=BD) if content == "natural" \
            else chroma_tool_frames(w, h, 2)
        maps_l, maps_c = frame_maps(preds, frames, w, h)
        if not dual:
            maps_c = [None, None]
        out = {}
        for device in ("cpu", DEVICE):
            enc = wf.WavefrontEncoder(enc_cfg(w, h, tools, dual), accel_level=3, device=device)
            t0 = time.perf_counter()
            out[device] = enc.encode_frames(frames, maps=maps_l, chroma_maps=maps_c)
            log(f"[encode-cpu-vs-card] {w}x{h} x 2, {tools}, "
                f"{'dual' if dual else 'single'} tree, {content} content, on {device}: "
                f"{time.perf_counter() - t0:.3f} s, {enc.steps} wave steps")
        for f in range(2):
            check(out["cpu"][f][0] == out[DEVICE][f][0],
                  f"frame {f} ({tools}, dual tree {dual}): CPU and card bitstreams differ")
        cc = chroma_codes(enc, maps_l, maps_c, 2)
        if content == "chroma tools":
            check(cc["lm"] > 0 and cc["joint"] > 0,
                  f"{tools}, dual tree {dual}: LM or the joint Cb-Cr trial never won ({cc})")
        log(f"[encode-cpu-vs-card] {tools}: bitstreams byte-identical "
            f"({[len(o[0]) for o in out[DEVICE]]} bytes); luma CUs "
            f"{luma_codes(enc, maps_l, maps_c, 2)}; chroma CUs {cc}"
            + (f"; CTUs with each ALF filter {enc.alf_ctus}" if enc.cfg.alf else ""))


def phase_encode_profile(frames, maps_l, maps_c) -> None:
    """One warm frame's wave scan under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    enc = wf.WavefrontEncoder(enc_cfg(ENC_W, ENC_H), accel_level=3, device=DEVICE)
    leaves, cleaves = enc._collect_all(None, maps_l[0], maps_c[0])
    fr = [(leaves, cleaves, *frames[0])]
    enc._batched_pass(fr)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        enc._batched_pass(fr)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    if not rows:
        log("[encode-profile] the profiler recorded no device time: not measured")
        return
    busy = sum(r[0] for r in rows)
    log(f"[encode-profile] one 1920x1080 frame's wave scan ({enc.steps} steps): wall "
        f"{wall_ms:.3f} ms, device busy {busy:.3f} ms, idle share {1 - busy / wall_ms:.3f}")
    for ms, count, name in rows[:16]:
        log(f"[encode-profile]   {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{count:<6d} "
            f"{name[:100]}")


# ---------------------------------------------------------------------------
# The device RDO: K9a, K9b, K9c (with K1, K4, K5, K6a) and its paths
# ---------------------------------------------------------------------------

RDO_KERNELS = {  # name: (wrapper, source, the TPU kernel it replaces)
    "rdo_luma_select": (rg.rdo_luma_select, "pmp_vvc_tpu_torch/csrc/rdo_leaf.cu",
                        "pmp_vvc_tpu/codec/rdo_device.py:77"),
    "rdo_chroma_select": (rg.rdo_chroma_select, "pmp_vvc_tpu_torch/csrc/rdo_leaf.cu",
                          "pmp_vvc_tpu/codec/rdo_device.py:581"),
    "rdo_leaf_cost": (rg.rdo_leaf_cost, "pmp_vvc_tpu_torch/csrc/rdo_leaf.cu",
                      "pmp_vvc_tpu/codec/rdo_device.py:122"),
}
RDO_W, RDO_H = 256, 192
RDO_CASES = ("rect at x = 0, y = 0", "rect on the right and bottom edges", "chroma side of 2",
             "64-pad rect", "LM won", "LM lost", "two QP points", "SSE above 2^24",
             "2x2 chroma TU")
# the label search (tools/gen_dataset.py): 512x512 natural content, four QPs;
# luma in single tree, the chroma channel in dual tree with CCLM
LABEL_W = LABEL_H = 512
LABEL_QPS = (22, 27, 32, 37)


def rdo_cfg(w: int, h: int, qp: int, chroma: bool = False, min_cb: int = 2) -> VVCConfig:
    """The label search's configuration (``tools/gen_dataset.py:mkenc``) at
    ``qp``: the bench's chroma QP table, MTT depth 3, BT/TT 32; with
    ``chroma`` the dual tree with CCLM; the minimum CU 2 ** ``min_cb``."""
    return VVCConfig(width=w, height=h, qp=qp, deblocking_disabled=True,
                     chroma_qp_start_minus26=-9, chroma_qp_points=((9, 12), (4, 5), (11, 7)),
                     log2_min_cb=min_cb, max_mtt_depth_intra=3, max_bt_intra=32,
                     max_tt_intra=32, dual_tree=chroma, cclm=chroma)


def rdo_rows(P: int, seed: int, width: int, height: int, n_frames: int = 2) -> np.ndarray:
    """(B, 8) int32 rows of the P-pad class, as ``DeviceRDO`` builds them:
    every size with its longer side in the class, at the frame's top-left
    and bottom-right corners and at random 4-aligned positions, order id 1,
    live, CCLM gate; then two padding rows."""
    rng = np.random.RandomState(seed)
    sides = [s for s in (4, 8, 16, 32, 64) if s <= P]
    sizes = [(w, h) for w in sides for h in sides if max(w, h) == P or P == 8]
    rows = []
    for i, (w, h) in enumerate(sizes * 4):
        x = rng.randint(0, (width - w) // 4 + 1) * 4
        y = rng.randint(0, (height - h) // 4 + 1) * 4
        if i < 2 * len(sizes):
            x, y = (0, 0) if i % 2 else (width - w, height - h)
        rows.append((i % n_frames, x, y, w, h, 1, 1, 1))
    rows += [(0,) * 8] * 2
    return np.array(rows, np.int32)


def rdo_planes(width: int, height: int) -> list:
    """(F=2, ...) int32 originals: natural content, and natural content with
    +-400 noise (SSEs above 2^24 in the 64-pad class)."""
    a = natural_frame(width, height, 21, bit_depth=BD)
    rng = np.random.RandomState(22)
    b = [np.clip(p + rng.randint(-400, 401, p.shape), 0, 1023)
         for p in natural_frame(width, height, 23, bit_depth=BD)]
    return [np.stack([a[i], b[i]]).astype(np.int32) for i in range(3)]


def rdo_qp_points(width: int, height: int, qps) -> tuple:
    return DeviceRDO._qp_points([wf.WavefrontEncoder(rdo_cfg(width, height, qp), device=DEVICE)
                                 for qp in qps])


def rdo_kernel_checks(P: int, planes, qps, errs: dict, seen: dict) -> None:
    """K1, K9a, K5, K4, K9c (luma tree) and K1, K9b, K6a, K4, K9c (chroma
    tree) on the P-pad class's ``rdo_rows``, each held to its plain version
    on the card, then the whole ``luma_leaf_costs`` / ``chroma_leaf_costs``
    to the plain one on the CPU."""
    cpu = [torch.from_numpy(p) for p in planes]
    oy, ou, ov = (p.to(DEVICE) for p in cpu)
    og0 = rg._zero_grid(oy)
    rows_np = rdo_rows(P, seed=P, width=RDO_W, height=RDO_H)
    rows = torch.from_numpy(rows_np).to(DEVICE)
    live = rows_np[:, 6] > 0
    w, h = rows_np[live, 3], rows_np[live, 4]
    x, y = rows_np[live, 1], rows_np[live, 2]
    Pc = P // 2
    seen["rect at x = 0, y = 0"] += int(((x == 0) & (y == 0)).sum())
    seen["rect on the right and bottom edges"] += int(((x + w == RDO_W) & (y + h == RDO_H)).sum())
    seen["chroma side of 2"] += int(((w == 4) | (h == 4)).sum())
    seen["64-pad rect"] += int(live.sum()) if P == 64 else 0
    seen["two QP points"] += len(qps) == 2
    refs = ref_gather([oy], og0, rows, P, 1, BD)
    _cmp("ref_gather", refs, ref_gather_reference([oy], og0, rows, P, 1, BD), errs)
    crefs = ref_gather([ou, ov], og0, rows, Pc, 2, BD)
    _cmp("ref_gather", crefs, ref_gather_reference([ou, ov], og0, rows, Pc, 2, BD), errs)

    # the luma tree
    sel = rg.rdo_luma_select(refs, crefs, oy, rows, P, BD)
    _cmp("rdo_luma_select", list(sel),
         list(rg.rdo_luma_select_reference(refs, crefs, oy, rows, P, BD)), errs)
    modes, pred, cpred = sel
    tiles = ttq._orgs_inside(oy, rows, P, 1)
    out = [[], [], [], []]
    for qp_y, qp_c, lam, dw in qps:
        args = ([oy], pred, rows, P, qp_y, BD, True, lam, modes, None, P <= 32)
        lev, rec, tr, lf = tq_mts(*args)
        _cmp("tq_mts", [lev, rec, tr, lf], list(tq_mts_reference(*args)), errs)
        args = ([ou, ov], cpred, rows, Pc, 2, qp_c, BD, True, lam, dw)
        lev_c, rec_c = tq(*args)
        _cmp("tq", [lev_c, rec_c], list(tq_reference(*args)), errs)
        check_levels_inside(lev[0], rows, P, 1, "K5")
        check_levels_inside(lev_c, rows, Pc, 2, "K4")
        seen["2x2 chroma TU"] += int(((w == 4) & (h == 4)).sum())
        err = ((rec[0] - tiles[0]) * tiles[1]).long()
        seen["SSE above 2^24"] += int(((err * err).sum((1, 2)) > 2 ** 24).sum())
        for k, t in enumerate((lev[0], rec[0], lev_c, rec_c)):
            out[k].append(t)
    args = (rows, P, [oy, ou, ov], *(torch.stack(t) for t in out), rg.qp_params(qps))
    _cmp("rdo_leaf_cost", rg.rdo_leaf_cost(*args), rg.rdo_leaf_cost_reference(*args), errs)
    got = rg.luma_leaf_costs(rows, oy, ou, ov, P, qps, BD, True, True)
    want = rg.luma_leaf_costs(rows.cpu(), *cpu, P, qps, BD, True, True)
    _cmp("luma_leaf_costs", [t.cpu() for t in got], list(want), errs)

    # the dual tree's chroma channel
    cpred, satd = rg.rdo_chroma_select(crefs, [ou, ov], rows, Pc, BD)
    _cmp("rdo_chroma_select", [cpred, satd],
         list(rg.rdo_chroma_select_reference(crefs, [ou, ov], rows, Pc, BD)), errs)
    args = (crefs, oy, [ou, ov], og0, rows, cpred, Pc, BD)
    cpred, use_lm = cclm_select(*args)
    _cmp("cclm", [cpred, use_lm], list(cclm_select_reference(*args)), errs)
    seen["LM won"] += int(use_lm.sum())
    seen["LM lost"] += int(live.sum() - use_lm.sum())
    out = [[], []]
    for _qp_y, qp_c, lam, dw in qps:
        args = ([ou, ov], cpred, rows, Pc, 2, qp_c, BD, True, lam, dw)
        lev_c, rec_c = tq(*args)
        _cmp("tq", [lev_c, rec_c], list(tq_reference(*args)), errs)
        check_levels_inside(lev_c, rows, Pc, 2, "K4")
        out[0].append(lev_c)
        out[1].append(rec_c)
    args = (rows, P, [None, ou, ov], None, None, *(torch.stack(t) for t in out),
            rg.qp_params(qps))
    _cmp("rdo_leaf_cost", rg.rdo_leaf_cost(*args), rg.rdo_leaf_cost_reference(*args), errs)
    got = rg.chroma_leaf_costs(rows, oy, ou, ov, P, qps, BD, True, True)
    want = rg.chroma_leaf_costs(rows.cpu(), *cpu, P, qps, BD, True, True)
    _cmp("chroma_leaf_costs", got.cpu(), want, errs)


def rdo_bounds(name: str, rows: np.ndarray, P: int, nqp: int,
               luma: bool = True) -> tuple[float, str, int, int]:
    """(bound ms, bound_by, bytes, ops) of one K9 call on these rows: K9a
    predicts 35 modes over each rect and scores their SATDs, then writes the
    winner's luma and chroma predictions; K9b predicts four candidates on U
    and V over the sides rounded up to 4 and scores them, then writes the
    winner's; chroma reads only the unfiltered top and left rows of each
    plane's four in K1's output (no chroma mode takes the filtered ones);
    K9c reads each QP point's levels and recon (luma too in the
    luma tree) and the originals once and sums squared errors and the rate
    proxy (about six operations a sample). Inputs read once, output tiles
    written whole."""
    live = rows[rows[:, 6] > 0]
    w, h = live[:, 3], live[:, 4]
    cw, ch = w // 2, h // 2
    B, Pc = len(rows), P // 2
    L, Lc = 2 * P + 3, 2 * Pc + 3
    if name == "rdo_luma_select":
        ops = int((w * h).sum()) * (35 * (OPS_PRED + OPS_SATD) + OPS_PRED) + \
            2 * int((cw * ch).sum()) * OPS_PRED
        nbytes = len(live) * (4 * L + 4 * Lc) * 4 + int((w * h).sum()) * 4 + \
            B * (P * P + 2 * Pc * Pc + 1) * 4 + B * 32
    elif name == "rdo_chroma_select":
        ops = 8 * int((np.maximum(cw, 4) * np.maximum(ch, 4)).sum()) * (OPS_PRED + OPS_SATD) + \
            2 * int((cw * ch).sum()) * OPS_PRED
        nbytes = len(live) * 4 * Lc * 4 + 2 * int((cw * ch).sum()) * 4 + \
            B * (2 * Pc * Pc + 1) * 4 + B * 32
    else:                               # rdo_leaf_cost
        samples = int((w * h * luma + 2 * cw * ch).sum())
        ops = 6 * nqp * samples
        nbytes = (2 * nqp + 1) * samples * 4 + B * (32 + 4 * nqp)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_rate(name)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def rdo_chunk_rows(rng, B: int, chroma: bool, P: int = 8) -> np.ndarray:
    """(B, 8) int32 rows of one P-pad chunk of 1080p rects at random
    4-aligned places: the luma tree's sizes of the class (4x4 to 8x8 at the
    8-pad class, every size whose longer side is P above it), or the chroma
    tree's (8x8 at the 8-pad class, above it every size whose longer side is
    P and whose sides are 8 or more)."""
    sides = [s for s in (4, 8, 16, 32, 64) if s <= P and (s >= 8 or not chroma)]
    sizes = [(w, h) for w in sides for h in sides if max(w, h) == P or P == 8]
    rows = np.zeros((B, 8), np.int32)
    rows[:, 3:5] = np.array(sizes)[rng.randint(len(sizes), size=B)]
    rows[:, 1] = rng.randint(0, (ENC_W - P) // 4, B) * 4
    rows[:, 2] = rng.randint(0, (ENC_H - P) // 4, B) * 4
    rows[:, 5:] = 1
    return rows


# K9a's tie and edge cases per pad class, (kind, w, h, place). Each rect
# lies in its own cell of K9A_GRID x K9A_GRID cells of 2P + 8 luma samples,
# so that no rect's references reach another rect's samples; the planes
# are noise (0-1023). "flat": references flat at FLAT_REC and the original
# at FLAT_ORG: the 35 costs tie and planar must win; "mode M": the original
# is mode M's prediction from its own references (cost 0): M must win, and
# its odd neighbours, which the RDO never scores, cannot take it; "tie
# 2/66": a square rect whose top reference row equals its left column and
# whose original is the symmetric part of mode 66's prediction, so that
# every mode costs what its mirror 68 - M costs and modes 2 and 66 tie at
# the least cost: 2, the earlier, must win; "random": the noise. Places:
# "inside" (every reference in the frame), "x = 0", "y = 0", "x = 0, y =
# 0", "right" and "bottom" (flush with the frame's edge). A padding row
# follows. 4x4, 4x8, 8x4 and 8x8 rects (4x4 SATD tiles, chroma sides of 2)
# occur in the 8-pad class; the 32x32, 64x64, 64x4 and 4x64 rects make a
# candidate span passes.
K9A_TIE_CASES = ("flat: planar wins a 35-way tie", "mode 2 wins", "mode 66 wins",
                 "another even angular wins", "2 and 66 tie: 2 wins", "4x4", "4x8", "8x4",
                 "8x8", "rect at x = 0", "rect at y = 0", "rect on the right edge",
                 "rect on the bottom edge", "padding row")
K9A_TIES = {
    8: (("flat", 8, 8, "inside"), ("flat", 4, 4, "inside"), ("mode 2", 4, 8, "inside"),
        ("mode 66", 8, 4, "inside"), ("mode 18", 8, 8, "inside"), ("mode 50", 4, 4, "inside"),
        ("tie 2/66", 8, 8, "inside"), ("tie 2/66", 4, 4, "inside"),
        ("random", 4, 4, "x = 0"), ("random", 8, 4, "y = 0"), ("random", 4, 8, "right"),
        ("random", 8, 8, "bottom"), ("random", 8, 8, "x = 0, y = 0")),
    16: (("flat", 16, 16, "inside"), ("mode 2", 16, 8, "inside"), ("mode 66", 8, 16, "inside"),
         ("mode 34", 16, 4, "inside"), ("mode 40", 4, 16, "inside"),
         ("tie 2/66", 16, 16, "inside"), ("random", 16, 16, "x = 0"),
         ("random", 4, 16, "y = 0"), ("random", 16, 4, "right"), ("random", 8, 16, "bottom")),
    32: (("flat", 32, 32, "inside"), ("mode 2", 32, 4, "inside"), ("mode 66", 4, 32, "inside"),
         ("mode 24", 32, 16, "inside"), ("tie 2/66", 32, 32, "inside"),
         ("random", 32, 8, "x = 0"), ("random", 8, 32, "y = 0"), ("random", 16, 32, "right"),
         ("random", 32, 32, "bottom")),
    64: (("flat", 64, 64, "inside"), ("mode 2", 64, 32, "inside"), ("mode 66", 4, 64, "inside"),
         ("mode 50", 64, 16, "inside"), ("tie 2/66", 64, 64, "inside"),
         ("random", 64, 4, "x = 0"), ("random", 32, 64, "y = 0"), ("random", 16, 64, "right"),
         ("random", 64, 64, "bottom")),
}
K9A_GRID = 4


def tie_places(ties, P: int) -> list:
    """The (x, y) luma places of ``ties``' (kind, w, h, place) rects, each in
    its own cell of K9A_GRID x K9A_GRID cells of 2P + 8 luma samples, so
    that no rect's references reach another rect's samples: "inside" (every
    reference in the frame), "x = 0", "y = 0", "x = 0, y = 0", "right" and
    "bottom" (flush with the frame's edge)."""
    C = 2 * P + 8
    W = H = K9A_GRID * C
    edge = {"x = 0": (0, 1), "y = 0": (1, 0), "x = 0, y = 0": (0, 0),
            "right": (K9A_GRID - 1, 1), "bottom": (1, K9A_GRID - 1)}
    inside = [(cx, cy) for cy in range(K9A_GRID) for cx in range(K9A_GRID)
              if (cx, cy) not in edge.values()]
    out = []
    for _, w, h, place in ties:
        cx, cy = inside.pop(0) if place == "inside" else edge[place]
        out.append((0 if place.startswith("x = 0") else W - w if place == "right" else cx * C + 4,
                    0 if place.endswith("y = 0") else H - h if place == "bottom" else cy * C + 4))
    return out


def k9a_tie_inputs(P: int, seed: int):
    """(rows, (oy, ou, ov), kinds, places) as numpy for ``K9A_TIES[P]``: 2
    frames of K9A_GRID x K9A_GRID cells of 2P + 8 luma samples, a case's
    frame its index mod 2, order id 1 (the RDO's open loop)."""
    rng = np.random.RandomState(seed)
    W = H = K9A_GRID * (2 * P + 8)
    oy = rng.randint(0, 1024, (2, H, W)).astype(np.int32)
    ou, ov = (rng.randint(0, 1024, (2, H // 2, W // 2)).astype(np.int32) for _ in range(2))
    rows, kinds, places = [], [], []
    for i, ((kind, w, h, place), (x, y)) in enumerate(zip(K9A_TIES[P], tie_places(K9A_TIES[P],
                                                                                   P))):
        fi = i % 2
        if kind == "flat":
            oy[fi, max(y - 1, 0):y + 2 * h, max(x - 1, 0):x + 2 * w] = FLAT_REC
        elif kind == "tie 2/66":          # the top reference row equals the left column
            v = rng.randint(0, 1024, 2 * w + 1)
            oy[fi, y - 1, x - 1:x + 2 * w] = v
            oy[fi, y - 1:y + 2 * h, x - 1] = v
        rows.append((fi, x, y, w, h, 1, 1, 1))
        kinds.append(kind)
        places.append(place)
    rows = np.array(rows + [(0,) * 8], np.int32)
    rows_t = torch.from_numpy(rows)
    og0 = torch.zeros((2, H // 4, W // 4), dtype=torch.int32)
    refs = ref_gather_reference([torch.from_numpy(oy)], og0, rows_t, P, 1, BD)
    target = [66 if k == "tie 2/66" else int(k.split()[1]) if k.startswith("mode") else 0
              for k in kinds] + [0]
    _, _, _, ws, hs, _, _ = unpack_rows(rows_t, 1)
    pred = predict_generic(*refs[0], torch.tensor(target, dtype=torch.int32)[:, None], ws, hs,
                           pad=P, is_luma=True, bit_depth=BD)[:, 0].numpy()
    for b, kind in enumerate(kinds):
        fi, x, y, w, h = rows[b, :5]
        t = pred[b, :h, :w]
        if kind == "flat":
            oy[fi, y:y + h, x:x + w] = FLAT_ORG
        elif kind.startswith("mode"):
            oy[fi, y:y + h, x:x + w] = t
        elif kind == "tie 2/66":          # symmetric: each mode ties its mirror
            oy[fi, y:y + h, x:x + w] = (t + t.T) // 2
    return rows, (oy, ou, ov), kinds, places


def k9a_tie_seen(rows: np.ndarray, kinds: list, places: list, modes: np.ndarray) -> np.ndarray:
    """Counts of ``K9A_TIE_CASES`` among K9a's chosen ``modes``; every flat
    rect must choose planar, every mode M rect M, every tie rect mode 2 and
    the padding row mode 0."""
    seen = np.zeros(len(K9A_TIE_CASES), np.int64)
    for b, kind in enumerate(kinds):
        want = {"flat": 0, "tie 2/66": 2}.get(kind)
        if kind.startswith("mode"):
            want = int(kind.split()[1])
        check(want is None or modes[b] == want, f"K9a chose mode {modes[b]} for a {kind} rect")
        w, h = (int(v) for v in rows[b, 3:5])
        seen += [kind == "flat", kind == "mode 2", kind == "mode 66",
                 kind.startswith("mode") and kind not in ("mode 2", "mode 66"),
                 kind == "tie 2/66", (w, h) == (4, 4), (w, h) == (4, 8), (w, h) == (8, 4),
                 (w, h) == (8, 8), rows[b, 1] == 0, rows[b, 2] == 0, places[b] == "right",
                 places[b] == "bottom", False]
    check(rows[-1, 6] == 0 and modes[-1] == 0, "K9a's padding row did not give mode 0")
    seen[-1] += 1
    return seen


def k9a_call(P: int, rows_np: np.ndarray, planes):
    """(K9a's call on these rows of the P-pad class with K1's references of
    the original ``planes`` (oy, ou, ov; (F, ...) numpy) on the card, as
    ``luma_leaf_costs`` makes it, its plain version's outputs)."""
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)  # noqa: E731
    oy, ou, ov = (dev(p) for p in planes)
    rows = dev(rows_np)
    og0 = rg._zero_grid(oy)
    args = (ref_gather([oy], og0, rows, P, 1, BD), ref_gather([ou, ov], og0, rows, P // 2, 2, BD),
            oy, rows, P, BD)
    return with_plain(lambda: rg.rdo_luma_select(*args),
                      lambda: rg.rdo_luma_select_reference(*args))


def with_plain(kernel, plain) -> tuple:
    """(``kernel``, with ``plain``, its plain version's call, as its
    ``plain`` attribute, for timing; ``plain()``'s outputs as a list)."""
    kernel.plain = plain
    return kernel, list(plain())


def k9a_tie_checks(P: int, seed: int, errs: dict) -> np.ndarray:
    """K9a against its plain version on ``k9a_tie_inputs``; the cases seen."""
    rows_np, planes, kinds, places = k9a_tie_inputs(P, seed)
    call, want = k9a_call(P, rows_np, planes)
    got = call()
    _cmp("rdo_luma_select", list(got), want, errs)
    return k9a_tie_seen(rows_np, kinds, places, got[0].cpu().numpy())


def k9a_rdo_call(P: int):
    """(K9a as the device RDO calls it on one chunk of the P-pad class
    (``_BATCH_CUDA[P]`` rects of a 1080p frame, ``rdo_chunk_rows``), its
    plain version's outputs)."""
    rows_np = rdo_chunk_rows(np.random.RandomState(5), trd._BATCH_CUDA[P], False, P)
    frame = natural_frame(ENC_W, ENC_H, 7, bit_depth=BD)
    return k9a_call(P, rows_np, [p[None].astype(np.int32) for p in frame])


# K9b's tie and edge cases per pad class (luma units), (kind, w, h, place),
# each rect in its own cell as K9A_TIES's (K9A_GRID x K9A_GRID cells of 2P +
# 8 luma samples), the planes noise (0-1023). "flat": both planes'
# references flat at FLAT_REC and the originals at FLAT_ORG: the four joint
# costs tie and planar must win; "DC", "HOR", "VER": both originals that
# candidate's prediction from their own references (joint cost 0): it must
# win; "tie": on both planes a reference row and column of the same
# alternating 1023 / 0 samples, the original the mean of the HOR and VER
# predictions (symmetric): HOR and VER tie at the least joint cost and HOR,
# the earlier, must win (the 8- to 32-pad classes: planar fits a 32x32
# one better); "joint": U's references within +-8 of 500 and its original
# U's HOR prediction, so that U alone would take HOR at cost 0, and V's
# original V's VER prediction on its noisy references: the joint sum must
# take VER; "random": the noise. Places as K9A_TIES'. A padding row follows.
K9B_TIE_CASES = ("flat: planar wins a 4-way tie", "DC wins", "DC wins on a non-square rect",
                 "HOR wins", "VER wins", "HOR and VER tie: HOR wins",
                 "the joint sum overrules U's own choice", "chroma side of 2",
                 "32x32 chroma (16 tiles a plane)", "rect at x = 0", "rect at y = 0",
                 "rect on the right edge", "rect on the bottom edge", "padding row")
K9B_TIES = {
    8: (("flat", 8, 8, "inside"), ("flat", 4, 4, "inside"), ("DC", 8, 4, "inside"),
        ("HOR", 4, 8, "inside"), ("VER", 8, 8, "inside"), ("tie", 8, 8, "inside"),
        ("tie", 4, 4, "inside"), ("joint", 8, 8, "inside"), ("random", 4, 4, "x = 0"),
        ("random", 8, 4, "y = 0"), ("random", 4, 8, "right"), ("random", 8, 8, "bottom"),
        ("random", 8, 8, "x = 0, y = 0")),
    16: (("flat", 16, 16, "inside"), ("DC", 16, 8, "inside"), ("HOR", 8, 16, "inside"),
         ("VER", 16, 4, "inside"), ("tie", 16, 16, "inside"), ("joint", 16, 16, "inside"),
         ("random", 16, 16, "x = 0"), ("random", 4, 16, "y = 0"), ("random", 16, 4, "right"),
         ("random", 8, 16, "bottom")),
    32: (("flat", 32, 32, "inside"), ("DC", 32, 16, "inside"), ("HOR", 32, 8, "inside"),
         ("VER", 4, 32, "inside"), ("tie", 32, 32, "inside"), ("joint", 16, 32, "inside"),
         ("random", 32, 8, "x = 0"), ("random", 8, 32, "y = 0"), ("random", 16, 32, "right"),
         ("random", 32, 32, "bottom")),
    64: (("flat", 64, 64, "inside"), ("DC", 64, 32, "inside"), ("DC", 4, 64, "inside"),
         ("HOR", 64, 64, "inside"), ("VER", 16, 64, "inside"), ("joint", 64, 64, "inside"),
         ("random", 64, 4, "x = 0"), ("random", 32, 64, "y = 0"), ("random", 16, 64, "right"),
         ("random", 64, 64, "bottom")),
}
K9B_WANT = {"flat": 0, "DC": 1, "HOR": 2, "VER": 3, "tie": 2, "joint": 3}


def k9b_candidates(rows: np.ndarray, planes, P: int) -> tuple:
    """(preds (2, B, 4, Pc, Pc), satds (2, B, 4)) as numpy: the four chroma
    candidates' predictions of U and V on the rows' rects (zero outside
    them) and each plane's SATDs, as the plain K9b computes them."""
    rows_t = torch.from_numpy(rows)
    oy, ou, ov = (torch.from_numpy(np.ascontiguousarray(p)) for p in planes)
    Pc = P // 2
    crefs = ref_gather_reference([ou, ov], rg._zero_grid(oy), rows_t, Pc, 2, BD)
    fi, cxs, cys, cws, chs, _, ok = unpack_rows(rows_t, 2)
    cand = torch.from_numpy(rg.CHROMA_CANDIDATES)[None].expand(len(rows), -1)
    inside = rg._cu_mask(cws, chs, ok, Pc)
    preds, satds = [], []
    for pl, org in enumerate((ou, ov)):
        p = predict_generic(*crefs[pl], cand, cws, chs, pad=Pc, is_luma=False, bit_depth=BD)
        satds.append(ttq.satd_generic(rg._tiles(org, fi, cxs, cys, Pc)[:, None], p, cws, chs))
        preds.append(torch.where(inside[:, None], p, 0))
    return torch.stack(preds).numpy(), torch.stack(satds).numpy()


def k9b_tie_inputs(P: int, seed: int):
    """(rows, (oy, ou, ov), kinds, places) as numpy for ``K9B_TIES[P]``: 2
    frames of K9A_GRID x K9A_GRID cells of 2P + 8 luma samples, a case's
    frame its index mod 2, order id 1 (the RDO's open loop)."""
    rng = np.random.RandomState(seed)
    W = H = K9A_GRID * (2 * P + 8)
    oy = rng.randint(0, 1024, (2, H, W)).astype(np.int32)
    ou, ov = (rng.randint(0, 1024, (2, H // 2, W // 2)).astype(np.int32) for _ in range(2))
    rows, kinds, places = [], [], []
    for i, ((kind, w, h, place), (x, y)) in enumerate(zip(K9B_TIES[P], tie_places(K9B_TIES[P],
                                                                                   P))):
        fi, xc, yc, wc, hc = i % 2, x // 2, y // 2, w // 2, h // 2
        top = (fi, yc - 1, slice(xc - 1, xc + 2 * wc))
        left = (fi, slice(yc - 1, yc + 2 * hc), xc - 1)
        if kind == "flat":
            for p in (ou, ov):
                p[fi, yc - 1:yc + 2 * hc, xc - 1:xc + 2 * wc] = FLAT_REC
        elif kind == "tie":               # the reference row equals the column
            v = np.where(np.arange(2 * wc + 1) % 2 == 0, 1023, 0)
            for p in (ou, ov):
                p[top], p[left] = v, v
        elif kind == "joint":             # U's references of low contrast
            ou[top] = 500 + rng.randint(-8, 9, 2 * wc + 1)
            ou[left] = 500 + rng.randint(-8, 9, 2 * hc + 1)
        rows.append((fi, x, y, w, h, 1, 1, 1))
        kinds.append(kind)
        places.append(place)
    rows = np.array(rows + [(0,) * 8], np.int32)
    preds = k9b_candidates(rows, (oy, ou, ov), P)[0]
    for b, kind in enumerate(kinds):
        fi, x, y, w, h = rows[b, :5]
        xc, yc, wc, hc = x // 2, y // 2, w // 2, h // 2
        for pl, p in enumerate((ou, ov)):
            t = preds[pl, b, :, :hc, :wc]
            if kind == "flat":
                p[fi, yc:yc + hc, xc:xc + wc] = FLAT_ORG
            elif kind == "tie":            # symmetric: HOR costs what VER costs
                p[fi, yc:yc + hc, xc:xc + wc] = (t[2].astype(np.int64) + t[3]) // 2
            elif kind == "joint":          # U's own best HOR, V's VER
                p[fi, yc:yc + hc, xc:xc + wc] = t[2 if pl == 0 else 3]
            elif kind in K9B_WANT:
                p[fi, yc:yc + hc, xc:xc + wc] = t[K9B_WANT[kind]]
    return rows, (oy, ou, ov), kinds, places


def k9b_tie_seen(rows: np.ndarray, kinds: list, places: list, satds: np.ndarray,
                 pred: np.ndarray, preds: np.ndarray, best: np.ndarray) -> np.ndarray:
    """Counts of ``K9B_TIE_CASES`` among K9b's outputs (``pred`` (2, B, Pc,
    Pc), ``best`` (B,) the winning SATD), against the candidates' ``preds``
    and ``satds`` (``k9b_candidates``): every case's margin holds, its
    candidate won (the least joint cost, the first of a tie otherwise), and
    the padding row gave zeros."""
    seen = np.zeros(len(K9B_TIE_CASES), np.int64)
    for b, kind in enumerate(kinds):
        u, v = satds[:, b]
        joint = u + v
        want = K9B_WANT.get(kind, int(np.argmin(joint)))
        if kind == "flat":
            check((joint == joint[0]).all() and joint[0] > 0, f"K9b flat rect {b}: {joint}")
        elif kind == "tie":
            check(u[2] == u[3] and v[2] == v[3] and joint[2] < joint[:2].min(),
                  f"K9b tie rect {b}: U {u}, V {v}")
        elif kind == "joint":
            check(np.argmin(u) == 2 and u[2] == 0 and joint[3] < np.delete(joint, 3).min(),
                  f"K9b joint rect {b}: U {u}, V {v}")
        elif kind in K9B_WANT:
            check(joint[want] == 0 < np.delete(joint, want).min(), f"K9b {kind} rect {b}: {joint}")
        check(np.array_equal(pred[:, b], preds[:, b, want]) and best[b] == joint[want],
              f"K9b chose other than candidate {want} for a {kind} rect")
        w, h = (int(s) for s in rows[b, 3:5])
        seen += [kind == "flat", kind == "DC", kind == "DC" and w != h, kind == "HOR",
                 kind == "VER", kind == "tie", kind == "joint", min(w, h) == 4, (w, h) == (64, 64),
                 rows[b, 1] == 0, rows[b, 2] == 0, places[b] == "right", places[b] == "bottom",
                 False]
    check(rows[-1, 6] == 0 and not pred[:, -1].any() and best[-1] == 0,
          "K9b's padding row did not give zeros")
    seen[-1] += 1
    return seen


def k9b_call(P: int, rows_np: np.ndarray, planes):
    """(K9b's call on these rows of the P-pad class with K1's references of
    the original U and V (``planes`` (oy, ou, ov); (F, ...) numpy) on the
    card, as ``chroma_leaf_costs`` makes it, its plain version's outputs)."""
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)  # noqa: E731
    oy, ou, ov = (dev(p) for p in planes)
    rows = dev(rows_np)
    args = (ref_gather([ou, ov], rg._zero_grid(oy), rows, P // 2, 2, BD), [ou, ov], rows,
            P // 2, BD)
    return with_plain(lambda: rg.rdo_chroma_select(*args),
                      lambda: rg.rdo_chroma_select_reference(*args))


def k9b_tie_checks(P: int, seed: int, errs: dict) -> np.ndarray:
    """K9b against its plain version on ``k9b_tie_inputs``; the cases seen."""
    rows_np, planes, kinds, places = k9b_tie_inputs(P, seed)
    call, want = k9b_call(P, rows_np, planes)
    got = call()
    _cmp("rdo_chroma_select", list(got), want, errs)
    preds, satds = k9b_candidates(rows_np, planes, P)
    return k9b_tie_seen(rows_np, kinds, places, satds, got[0].cpu().numpy(), preds,
                        got[1].cpu().numpy())


def k9b_rdo_call(P: int):
    """(K9b as the device RDO calls it on one chunk of the P-pad class's
    chroma tree (``_BATCH_CUDA[P]`` rects of a 1080p frame), its plain
    version's outputs)."""
    rows_np = rdo_chunk_rows(np.random.RandomState(5), trd._BATCH_CUDA[P], True, P)
    frame = natural_frame(ENC_W, ENC_H, 7, bit_depth=BD)
    return k9b_call(P, rows_np, [p[None].astype(np.int32) for p in frame])


# K9c's edge cases: the rects of every size of a class (``rdo_rows``: the
# frame's top-left and bottom-right corners among them, chroma sides of 2
# in the 8-pad class, two padding rows) on the noisy and the natural frame
# of ``rdo_planes``, four QP points (K9C_QPS; lam and dw not round in
# float32), levels mostly small with every rect holding +-32,767 and
# -32,768 (bit lengths 15 and 16) and zero beyond it, as K4's and K5's
# round trips leave them (K9c counts the rect's levels, the plain version
# the whole tile's), recon beyond the rect garbage (the SSE counts inside
# only), within +-4 of the original in half the rects and noise in the
# others (SSEs above 2^24); both trees, at 1 and 4 QP points.
K9C_EDGE_CASES = ("luma tree", "chroma tree", "1 QP point", "4 QP points", "SSE above 2^24",
                  "levels at +-32,767 and -32,768 (bit lengths 15 and 16)",
                  "rect on the right and bottom edges", "chroma side of 2", "padding row")
K9C_QPS = ((22, 23, 16.0625, 1.0905077), (27, 27, 32.4, 1.0), (32, 31, 64.75, 0.9170040),
           (37, 35, 129.3, 0.8408964))


def k9c_edge_inputs(P: int, seed: int) -> tuple:
    """(rows, (oy, ou, ov), lev, rec, lev_c, rec_c) as numpy for K9c's edge
    cases in the P-pad class, at the four QP points of K9C_QPS: lev, rec
    (4, B, P, P), lev_c, rec_c (4, 2, B, P/2, P/2) int32."""
    rng = np.random.RandomState(seed)
    rows = rdo_rows(P, seed=seed, width=RDO_W, height=RDO_H)
    planes = rdo_planes(RDO_W, RDO_H)
    B, Pc, nq = len(rows), P // 2, len(K9C_QPS)

    def tiles(plane, scale, pad):
        org, _, _, _, _ = ttq._orgs_inside(torch.from_numpy(plane), torch.from_numpy(rows), pad,
                                           scale)
        lev = rng.choice([0, 0, 0, 1, -1, 2, -5, 40], (nq, B, pad, pad))
        for q in range(nq):                 # the 16-bit limits in every rect
            lev[q, :, q % 2, 0], lev[q, :, 0, (q + 1) % 2] = 32767, -32768
            lev[q, :, 1, 1] = -32767
        near = org.numpy()[None] + rng.randint(-4, 5, (nq, B, pad, pad))
        rec = np.where((np.arange(B) % 2 == 0)[None, :, None, None], near,
                       rng.randint(0, 1024, (nq, B, pad, pad)))
        inside = ttq._orgs_inside(torch.from_numpy(plane), torch.from_numpy(rows), pad,
                                  scale)[1].numpy()[None]
        rec = np.where(inside, rec, rng.randint(-2000, 2000, rec.shape))
        return (lev * inside).astype(np.int32), rec.astype(np.int32)

    lev, rec = tiles(planes[0], 1, P)
    cl = [tiles(p, 2, Pc) for p in planes[1:]]
    lev_c, rec_c = (np.stack([c[k] for c in cl], 1) for k in range(2))
    return rows, planes, lev, rec, lev_c, rec_c


def k9c_edge_calls(P: int) -> list:
    """(label, the call's arguments of ``rdo_leaf_cost`` as numpy / tuples:
    rows, pad, orgs, lev, rec, lev_c, rec_c, QP points) of K9c's edge cases
    in the P-pad class: both trees at 1 and 4 QP points."""
    rows, planes, lev, rec, lev_c, rec_c = k9c_edge_inputs(P, seed=40 + P)
    out = []
    for luma, nq in itertools.product((True, False), (1, 4)):
        out.append((f"{P}-pad {'luma' if luma else 'chroma'} tree, {nq} QP point(s)",
                    (rows, P, list(planes) if luma else [None, *planes[1:]],
                     lev[:nq] if luma else None, rec[:nq] if luma else None, lev_c[:nq],
                     rec_c[:nq], K9C_QPS[:nq])))
    return out


def k9c_edge_seen(args: tuple, cost: np.ndarray) -> np.ndarray:
    """Counts of ``K9C_EDGE_CASES`` in one edge call (``cost`` its plain
    version's output)."""
    rows, P, orgs, lev, rec, lev_c, rec_c, qps = args
    live = rows[:, 6] > 0
    w, h, x, y = rows[live, 3], rows[live, 4], rows[live, 1], rows[live, 2]
    levs = [lev_c] if lev is None else [lev, lev_c]
    rows_t = torch.from_numpy(rows)
    sses = [((torch.from_numpy(r) - o) * m).long().pow(2).sum((-1, -2)).max()
            for r, (o, m) in [(rec_c[:, pl], ttq._orgs_inside(torch.from_numpy(orgs[1 + pl]),
                                                              rows_t, P // 2, 2)[:2])
                              for pl in range(2)] +
            ([(rec, ttq._orgs_inside(torch.from_numpy(orgs[0]), rows_t, P, 1)[:2])]
             if lev is not None else [])]
    return np.array([lev is not None, lev is None, len(qps) == 1, len(qps) == 4,
                     max(sses) > 2 ** 24,
                     all((a == 32767).any() and (a == -32768).any() for a in levs),
                     ((x + w == RDO_W) & (y + h == RDO_H)).any(), (np.minimum(w, h) == 4).any(),
                     (~live).any() and not cost[:, ~live].any()], np.int64)


def k9c_call(args: tuple):
    """(K9c's call on these numpy arguments (``k9c_edge_calls``) on the
    card, its plain version's outputs)."""
    rows, P, orgs, lev, rec, lev_c, rec_c, qps = args
    def dev(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
    a = (dev(rows), P, [dev(o) for o in orgs], dev(lev), dev(rec), dev(lev_c), dev(rec_c),
         rg.qp_params(qps).to(DEVICE))
    return with_plain(lambda: [rg.rdo_leaf_cost(*a)], lambda: [rg.rdo_leaf_cost_reference(*a)])


def k9c_edge_checks(errs: dict) -> np.ndarray:
    """K9c against its plain version on every class's edge calls; the cases
    seen."""
    seen = np.zeros(len(K9C_EDGE_CASES), np.int64)
    for P in (8, 16, 32, 64):
        for _, args in k9c_edge_calls(P):
            call, want = k9c_call(args)
            _cmp("rdo_leaf_cost", call(), want, errs)
            seen += k9c_edge_seen(args, want[0].cpu().numpy())
    return seen


def check_levels_inside(lev: torch.Tensor, rows: torch.Tensor, pad: int, scale: int,
                        who: str) -> None:
    """K9c counts a rect's levels inside the rect, its plain version (as the
    JAX package) the whole tile: the two agree because K4 and K5 leave the
    levels zero beyond each rect and on padding rows. Checks that on ``lev``
    (..., B, pad, pad), ``who``'s output on ``rows`` (chroma: ``scale`` 2)."""
    _, _, _, ws, hs, _, live = unpack_rows(rows, scale)
    d = torch.arange(pad, device=rows.device)
    inside = (d[None, :, None] < hs[:, None, None]) & (d[None, None, :] < ws[:, None, None]) \
        & live[:, None, None]
    check(not lev.masked_fill(inside, 0).any(),
          f"{who}: nonzero levels beyond a rect or on a padding row at pad {pad}")


def k9c_rdo_call(P: int, chroma: bool, nqp: int):
    """(K9c as the device RDO calls it on one chunk of the P-pad class
    (``_BATCH_CUDA[P]`` rects of a 1080p frame) of the luma or the chroma
    tree, at the label search's first ``nqp`` QP points, on K4's and K5's
    round trips of K9a's or K9b's predictions; its plain version's
    outputs)."""
    rows_np = rdo_chunk_rows(np.random.RandomState(5), trd._BATCH_CUDA[P], chroma, P)
    frame = natural_frame(ENC_W, ENC_H, 7, bit_depth=BD)
    oy, ou, ov = (torch.from_numpy(p[None].astype(np.int32)).to(DEVICE) for p in frame)
    rows = torch.from_numpy(rows_np).to(DEVICE)
    og0 = rg._zero_grid(oy)
    crefs = ref_gather([ou, ov], og0, rows, P // 2, 2, BD)
    qps = rdo_qp_points(ENC_W, ENC_H, LABEL_QPS[:nqp])
    if chroma:
        cpred, _ = rg.rdo_chroma_select(crefs, [ou, ov], rows, P // 2, BD)
    else:
        refs = ref_gather([oy], og0, rows, P, 1, BD)
        modes, pred, cpred = rg.rdo_luma_select(refs, crefs, oy, rows, P, BD)
    out = [[], [], [], []]
    for qp_y, qp_c, lam, dw in qps:
        if not chroma:
            lev, rec, _, _ = tq_mts([oy], pred, rows, P, qp_y, BD, True, lam, modes,
                                    mts=P <= 32)
            check_levels_inside(lev[0], rows, P, 1, "K5")
            out[0].append(lev[0])
            out[1].append(rec[0])
        for k, t in enumerate(tq([ou, ov], cpred, rows, P // 2, 2, qp_c, BD, True, lam, dw)):
            out[2 + k].append(t)
        check_levels_inside(out[2][-1], rows, P // 2, 2, "K4")
    st = [torch.stack(t) if t else None for t in out]
    args = (rows, P, [None if chroma else oy, ou, ov], *st, rg.qp_params(qps).to(DEVICE))
    return with_plain(lambda: [rg.rdo_leaf_cost(*args)],
                      lambda: [rg.rdo_leaf_cost_reference(*args)])


def phase_rdo_kernels() -> tuple[dict, dict]:
    """K9a/K9b/K9c, and K1, K4, K5, K6a as the RDO calls them, against their
    plain versions on ``rdo_rows`` of every tile class (``RDO_CASES`` must
    all occur), then each new kernel's times at the main path's chunk of the
    8-pad class (the most numerous: 16,384 rects of one 1080p frame)."""
    errs: dict = {}
    seen = dict.fromkeys(RDO_CASES, 0)
    planes = rdo_planes(RDO_W, RDO_H)
    qps = rdo_qp_points(RDO_W, RDO_H, (22, 37))
    for P in (8, 16, 32, 64):
        rdo_kernel_checks(P, planes, qps, errs, seen)
    check(all(seen.values()), f"some K9 case never occurred: {seen}")
    log(f"[rdo-kernels] K9a/K9b/K9c with K1/K4/K5/K6a, and luma_leaf_costs / "
        f"chroma_leaf_costs against the CPU's, equal to their plain versions on every "
        f"tile class (max_abs_err {errs}); cases: "
        + ", ".join(f"{k} {v}" for k, v in seen.items()))
    ties = sum(k9a_tie_checks(P, P, errs) for P in K9A_TIES)
    check((ties > 0).all(), f"some K9a tie case never occurred: {dict(zip(K9A_TIE_CASES, ties))}")
    log(f"[rdo-kernels] K9a equal to its plain version on its tie and edge cases at pads "
        f"{tuple(K9A_TIES)}: " + ", ".join(f"{k} {v}" for k, v in zip(K9A_TIE_CASES, ties)))
    ties = sum(k9b_tie_checks(P, P, errs) for P in K9B_TIES)
    check((ties > 0).all(), f"some K9b tie case never occurred: {dict(zip(K9B_TIE_CASES, ties))}")
    log(f"[rdo-kernels] K9b equal to its plain version on its tie and edge cases at pads "
        f"{tuple(K9B_TIES)}: " + ", ".join(f"{k} {v}" for k, v in zip(K9B_TIE_CASES, ties)))
    edges = k9c_edge_checks(errs)
    check((edges > 0).all(), f"some K9c edge case never occurred: "
                             f"{dict(zip(K9C_EDGE_CASES, edges))}")
    log("[rdo-kernels] K9c equal to its plain version on its edge cases at every pad class: "
        + ", ".join(f"{k} {v}" for k, v in zip(K9C_EDGE_CASES, edges)))

    # times at the main path's shapes: one full 8-pad chunk of 1080p rects
    # (luma tree: 4x4 to 8x8; chroma tree: 8x8), one QP point (QP 22)
    B = trd._BATCH_CUDA[8]
    times = {}
    for name, make, chroma in (("rdo_luma_select", k9a_rdo_call, False),
                               ("rdo_chroma_select", k9b_rdo_call, True),
                               ("rdo_leaf_cost", lambda P: k9c_rdo_call(P, False, 1), False)):
        kernel, want = make(8)
        got = kernel()
        _cmp(name, list(got), want, errs)
        rows_np = rdo_chunk_rows(np.random.RandomState(5), B, chroma)
        bound, by, nbytes, ops = rdo_bounds(name, rows_np, 8, 1)
        ms, plain_ms = graph_ms(kernel, reps=10, iters=5), call_ms(kernel.plain, 5)
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
        log(f"[rdo-kernels] {name}: {B} rects of the 8-pad {'chroma' if chroma else 'luma'} "
            f"tree: device time per call (CUDA graph) {ms:.6f} ms; plain version from Python "
            f"{plain_ms:.6f} ms; bound {bound:.6f} ms by {by} ({nbytes} B, {ops} ops)")
    # K9b's and K9c's bounds at every class's chunk (times: --k9b-times,
    # --k9c-times)
    for P in (8, 16, 32, 64):
        for chroma in (True, False):
            rows_np = rdo_chunk_rows(np.random.RandomState(5), trd._BATCH_CUDA[P], chroma, P)
            for name, nqp in ((("rdo_chroma_select", 1),) if chroma else ()) + (
                    ("rdo_leaf_cost", 1), ("rdo_leaf_cost", 4)):
                bound, by, nbytes, ops = rdo_bounds(name, rows_np, P, nqp, not chroma)
                log(f"[rdo-kernels] {name} bound: {trd._BATCH_CUDA[P]} rects of the {P}-pad "
                    f"{'chroma' if chroma else 'luma'} tree, {nqp} QP point(s): {bound:.6f} ms "
                    f"by {by} ({nbytes} B, {ops} ops)")
    # K9a at the other classes' chunks, each full (16-pad 8,192 rects, 32-pad
    # 2,048, 64-pad 512), every size of the class
    for P in (16, 32, 64):
        kernel, want = k9a_rdo_call(P)
        _cmp("rdo_luma_select", kernel(), want, errs)
        rows_np = rdo_chunk_rows(np.random.RandomState(5), trd._BATCH_CUDA[P], False, P)
        bound, by, nbytes, ops = rdo_bounds("rdo_luma_select", rows_np, P, 1)
        ms = graph_ms(kernel, reps=10, iters=5)
        log(f"[rdo-kernels] rdo_luma_select: {trd._BATCH_CUDA[P]} rects of the {P}-pad luma "
            f"tree: device time per call (CUDA graph) {ms:.6f} ms; bound {bound:.6f} ms by "
            f"{by} ({nbytes} B, {ops} ops), {bound / ms:.2%} of it")
    return errs, times


def reset_rdo_counts() -> None:
    for fn, _, _ in RDO_KERNELS.values():
        fn.launches = 0


def all_launches() -> dict:
    return {name: fn.launches for name, (fn, _, _) in {**ENC_KERNELS, **RDO_KERNELS}.items()}


def cu_sizes(leaves) -> dict:
    """Luma CUs per size over frames' (luma, chroma) leaves."""
    return dict(sorted(collections.Counter(
        f"{w}x{h}" for lv, _ in leaves for _, _, w, h, _ in lv).items()))


def check_hashes(outs, frames, label: str) -> None:
    for f, (bs, recon) in enumerate(outs):
        want = [hashlib.md5(p.astype("<u2").tobytes()).digest() for p in recon]
        check(sei_md5s(bs) == [want], f"{label}, frame {f}: hash SEI differs from the recon's MD5")
        err = (recon[0].astype(np.int64) - frames[f][0]) ** 2
        check(10 * np.log10(1023 * 1023 / err.mean()) > 30, f"{label}, frame {f}: luma PSNR")


def phase_rdo_encode(frames, maps_l, maps_c, enc_l3) -> dict:
    """The RDO's main path: the 1080p x 2 main-path encode at accel level 0
    with ``rdo_fallback`` (every MTT node deferred, QT splits below the QT
    map banned): a cold run (the node DAGs built), then a warm one whose
    launches are counted; stage times with the RDO's (geometry, leaf costs
    with their device span, DP), deferred nodes, CUs per size against the
    L3 run of the same frames (``enc_l3``), hash SEI."""
    enc = wf.WavefrontEncoder(enc_cfg(ENC_W, ENC_H), accel_level=0, rdo_fallback=True,
                              device=DEVICE)
    trd._GEOM_CACHE.clear()
    t0 = time.perf_counter()
    enc.encode_frames(frames, maps=maps_l, chroma_maps=maps_c)
    stages = ", ".join(f"{k} {v:.3f}" for k, v in enc.timings.items())
    log(f"[rdo-encode] L0 cold run (node DAGs built) {time.perf_counter() - t0:.3f} s "
        f"({stages} s)")
    reset_counts()
    with k9_pads() as pads:
        outs = timed_encode(enc, frames, maps_l, maps_c, f"{MAIN} at L0 with the device RDO, "
                            "the RDO path")
    launches = all_launches()
    for name, c in pads.items():
        check(sum(c.values()) == launches[name],
              f"{name} launches {launches[name]} against its calls by pad {c}")
    log_k9_pads("[rdo-encode]", pads, "at L0")
    for name in RDO_KERNELS:
        check(launches[name] > 0, f"{name} was not launched on the RDO path")
    check_hashes(outs, frames, "L0")
    log(f"[rdo-encode] {ENC_W}x{ENC_H} x {ENC_FRAMES} frames at L0: launches {launches}; "
        f"deferred nodes per frame {[len(s) for s in enc.rdo_deferred]}; {enc.steps} wave "
        f"steps; {[len(o[0]) for o in outs]} bytes; hash SEI equal to the recon's MD5")
    log(f"[rdo-encode] luma CUs per size at L0 {cu_sizes(enc.leaves)}; at L3 "
        f"{cu_sizes(enc_l3.leaves)}")
    return launches


class _PadCount:
    """The ``rdo_leaf`` library with each K9 kernel's calls counted by pad
    class (luma units; K9c by class, tree and QP points)."""

    def __init__(self, lib, counts: dict):
        self._lib, self._counts = lib, counts

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def pmp_rdo_luma_select(self, *args):
        self._counts["rdo_luma_select"][args[7]] += 1          # refs ... tabs_c, B, then P
        return self._lib.pmp_rdo_luma_select(*args)

    def pmp_rdo_chroma_select(self, *args):
        self._counts["rdo_chroma_select"][2 * args[6]] += 1    # crefs ... tabs_c, B, then Pc
        return self._lib.pmp_rdo_chroma_select(*args)

    def pmp_rdo_leaf_cost(self, *args):                        # nqp, B, P, H, W, luma
        self._counts["rdo_leaf_cost"][(args[11], "luma" if args[14] else "chroma",
                                       args[9])] += 1
        return self._lib.pmp_rdo_leaf_cost(*args)


@contextlib.contextmanager
def k9_pads():
    """K9a's, K9b's and K9c's launches counted by pad class meanwhile:
    yields {kernel: Counter}."""
    counts = {name: collections.Counter() for name in RDO_KERNELS}
    saved = rg._lib
    rg._lib = lambda n: _PadCount(saved(n), counts) if n == "rdo_leaf" else saved(n)
    try:
        yield counts
    finally:
        rg._lib = saved


def log_k9_pads(tag: str, counts: dict, where: str) -> None:
    for name, c in counts.items():
        log(f"{tag} {name} launches per pad class {where}: "
            + ", ".join(f"{k}: {v}" for k, v in sorted(c.items())))


def accel_maps(w: int, h: int):
    """Maps with MTT structure (the JAX package's tests/test_accel_levels.py
    ``_maps``): every edge present, QT to 16x16, BT_H at MTT depth 0, BT_V at
    depth 1, nothing deeper; L1 defers from MTT depth 1, L2 from 2, L3 none."""
    hor = np.ones((h // 4, w // 4), np.int32)
    ver = np.ones((h // 4, w // 4), np.int32)
    qt = np.full((h // 8, w // 8), 2, np.int32)
    dire = np.zeros((3, h // 4, w // 4), np.int32)
    dire[0], dire[1] = 1, -1
    return hor, ver, qt, dire


def phase_rdo_bench(preds: dict) -> None:
    """The bench's configuration (``bench.py:186-197``, ``rdo_fallback``
    on) at 416x240 x 2 frames of natural content with the QP 22 maps. The
    maps cover whole 64x64 blocks only (384x192), and the partitioner defers
    every node outside them at every level: at L3 K9 runs for those nodes
    and no others. On the frames cut to the covered 384x192 nothing defers at
    L3: K9 launches 0 times and the stream equals the one without the
    fallback. At L0, L1 and L2 K9 runs wherever nodes defer, and the four
    levels give at least three distinct streams. Then ``encode_frame(rdo=
    True)`` on one frame."""
    frames = natural_sequence(SMALL_W, SMALL_H, 2, seed0=7, bit_depth=BD)
    maps_l, maps_c = frame_maps(preds, frames, SMALL_W, SMALL_H)
    cw, ch = SMALL_W // 64 * 64, SMALL_H // 64 * 64
    cfg = enc_cfg(SMALL_W, SMALL_H, BENCH)
    streams = {}
    for level in (3, 0, 1, 2):
        enc = wf.WavefrontEncoder(cfg, accel_level=level, rdo_fallback=True, device=DEVICE)
        reset_rdo_counts()
        t0 = time.perf_counter()
        outs = enc.encode_frames(frames, maps=maps_l, chroma_maps=maps_c)
        wall = time.perf_counter() - t0
        k9 = {name: fn.launches for name, (fn, _, _) in RDO_KERNELS.items()}
        deferred = [len(s) for s in enc.rdo_deferred]
        check_hashes(outs, frames, f"bench L{level}")
        check((min(k9.values()) > 0) == (sum(deferred) > 0) and
              (max(k9.values()) > 0) == (sum(deferred) > 0),
              f"L{level}: K9 launches {k9} against deferred nodes {deferred}")
        if level == 3:
            check(all(x + w > cw or y + h > ch for d in enc.rdo_deferred
                      for _, x, y, w, h, _ in d),
                  "L3 deferred a node the maps cover")
        streams[level] = b"".join(o[0] for o in outs)
        stages = ", ".join(f"{k} {v:.3f}" for k, v in enc.timings.items())
        log(f"[rdo-bench] {SMALL_W}x{SMALL_H} x 2, {BENCH}, L{level} with rdo_fallback: "
            f"{wall:.3f} s ({stages} s); deferred nodes {deferred}; K9 launches {k9}; "
            f"{len(streams[level])} bytes; luma CUs {cu_sizes(enc.leaves)}")
    check(len(set(streams.values())) >= 3,
          f"L0-L3 gave {len(set(streams.values()))} distinct streams")

    # the frames cut to the maps' coverage: at L3 the fallback is never asked
    cut = [(y[:ch, :cw], u[:ch // 2, :cw // 2], v[:ch // 2, :cw // 2]) for y, u, v in frames]
    out = {}
    for fallback in (True, False):
        enc = wf.WavefrontEncoder(enc_cfg(cw, ch, BENCH), accel_level=3,
                                  rdo_fallback=fallback, device=DEVICE)
        reset_rdo_counts()
        out[fallback] = [o[0] for o in enc.encode_frames(cut, maps=maps_l, chroma_maps=maps_c)]
        if fallback:
            check(all(fn.launches == 0 for fn, _, _ in RDO_KERNELS.values())
                  and enc.rdo_deferred == [set(), set()], "K9 ran at L3 with full maps")
    check(out[True] == out[False], "L3 with the fallback differs from L3 without it")

    enc = wf.WavefrontEncoder(cfg, accel_level=3, device=DEVICE)
    reset_rdo_counts()
    t0 = time.perf_counter()
    res = enc.encode_frame(*frames[0], rdo=True)
    check_hashes([res], frames[:1], "rdo=True")
    check(all(fn.launches > 0 for fn, _, _ in RDO_KERNELS.values()), "rdo=True launched no K9")
    log(f"[rdo-bench] {len(set(streams.values()))} distinct streams over L0-L3; at L3 the "
        f"fallback decided only nodes outside the maps' {cw}x{ch}; on the frames cut to "
        f"{cw}x{ch}, L3 with the fallback launched no K9 and its stream equals the one "
        f"without it ({[len(b) for b in out[True]]} bytes); encode_frame(rdo=True), one "
        f"frame: {time.perf_counter() - t0:.3f} s, {len(res[0])} bytes, luma CUs "
        f"{cu_sizes(enc.leaves)}")


def phase_rdo_labels() -> None:
    """The label search: ``search_frames`` (luma, single tree) and
    ``search_frames_chroma`` (dual tree, CCLM) with four encoders (QP
    22/27/32/37) on 2 frames of 512x512 natural content, against four
    single-QP searches: every node's decision equal."""
    frames = [natural_frame(LABEL_W, LABEL_H, 1000 + i, bit_depth=BD) for i in range(2)]
    for chroma in (False, True):
        encs = [wf.WavefrontEncoder(rdo_cfg(LABEL_W, LABEL_H, qp, chroma, min_cb=3),
                                    device=DEVICE) for qp in LABEL_QPS]
        rdo = DeviceRDO(encs[0])
        t0 = time.perf_counter()
        geom = rdo.geom_chroma() if chroma else rdo.geom()
        t1 = time.perf_counter()
        run = (lambda r, **kw: r.search_frames_chroma(frames, **kw)) if chroma else \
            (lambda r, **kw: r.search_frames(frames, **kw))
        with k9_pads() as pads:
            multi = run(rdo, encoders=encs)
        t2 = time.perf_counter()
        log_k9_pads("[rdo-labels]", {k: c for k, c in pads.items() if c},
                    f"in the {'chroma' if chroma else 'luma'} 4-QP search")
        for q, enc in enumerate(encs):
            alone = run(DeviceRDO(enc))
            for f in range(len(frames)):
                check(np.array_equal(multi[q][f].chosen, alone[0][f].chosen),
                      f"label search QP {LABEL_QPS[q]}, frame {f}: trees differ")
        t3 = time.perf_counter()
        log(f"[rdo-labels] {'chroma (dual tree)' if chroma else 'luma (single tree)'}, "
            f"{LABEL_W}x{LABEL_H} x 2, QP {LABEL_QPS}: {len(geom.keys)} nodes, "
            f"{len(geom.rects)} rects (node DAG {t1 - t0:.3f} s); one 4-QP search "
            f"{t2 - t1:.3f} s, four single-QP searches {t3 - t2:.3f} s; the trees equal")


def phase_rdo_cpu_vs_card() -> None:
    """The RDO paths on the CPU (plain versions) and on the card, the bench's
    tools: L1 at 128x128 with ``accel_maps`` in dual tree, and
    ``encode_frame(rdo=True)`` at 208x120 in single tree; byte-identical."""
    for label, w, h, dual in (("L1 with rdo_fallback", 128, 128, True),
                              ("encode_frame(rdo=True)", 208, 120, False)):
        frame = natural_frame(w, h, 11, bit_depth=BD)
        out = {}
        for device in ("cpu", DEVICE):
            t0 = time.perf_counter()
            if dual:
                enc = wf.WavefrontEncoder(enc_cfg(w, h, BENCH, True), accel_level=1,
                                          rdo_fallback=True, device=device)
                out[device] = enc.encode_frame(*frame, maps=accel_maps(w, h))[0]
            else:
                enc = wf.WavefrontEncoder(enc_cfg(w, h, BENCH, False), device=device)
                out[device] = enc.encode_frame(*frame, rdo=True)[0]
            log(f"[rdo-cpu-vs-card] {w}x{h}, {label}, {'dual' if dual else 'single'} tree, "
                f"on {device}: {time.perf_counter() - t0:.3f} s")
        check(out["cpu"] == out[DEVICE], f"{label}: CPU and card bitstreams differ")
        log(f"[rdo-cpu-vs-card] {label}: bitstreams byte-identical ({len(out[DEVICE])} bytes)")


# ---------------------------------------------------------------------------
# Training: K11a (the QBD loss with its gradient), K11b (Adam) and the stages
# ---------------------------------------------------------------------------

TRAIN_KERNELS = {  # name: (wrapper, source, the TPU kernel it replaces)
    "qbd_loss": (tg.qbd_loss, "pmp_vvc_tpu_torch/csrc/qbd_loss.cu",
                 "pmp_vvc_tpu/train/losses.py:79"),
    "adam_update": (tg.adam_update, "pmp_vvc_tpu_torch/csrc/adam.cu",
                    "pmp_vvc_tpu/train/trainer.py:53"),
}
TRAIN_BATCH = 32                       # tools/train_bd.py:32
# (mode, qp, luma, batch): the three modes, both weight matrices, QP 22
# (w0 = 1) and 37; batch 7 makes the element counts no power of two
TRAIN_LOSS_CASES = (("q", 22, True, 32), ("bd", 22, True, 32), ("bd", 37, False, 32),
                    ("qbd", 22, False, 32), ("qbd", 37, True, 32), ("qbd", 27, True, 7))
# K11a against its plain version on the card. The loss: the kernel sums
# each mean in float64 and rounds once, torch sums float32 in its own order,
# then both combine ten terms in float32; 1e-6 relative is 8 ulps. Each
# gradient element sums at most three products in another order than
# autograd (whose mean backward may multiply by 1/count on the card): 2 ulps
# of the tensor's largest element.
TRAIN_LOSS_REL, TRAIN_GRAD_ULPS = 1e-6, 2
LABEL_SPLITS = (("Train", 4, 1000), ("Validate", 1, 2000))   # frames, seed0
BD_EPOCHS, JOINT_EPOCHS = 6, 4


def loss_case(n: int, seed: int) -> list:
    """(qt_out, bd0, bd1, bd2, qt_label, bt, dire) on the card: seeded
    outputs, with a quarter of the positions equal to their labels in every
    branch (exact zeros in every term, where |x|'s gradient is +1)."""
    rng = np.random.RandomState(seed)
    bt = rng.randint(0, 4, (n, 3, 16, 16)).astype(np.float32)
    dire = rng.randint(-1, 2, (n, 3, 16, 16)).astype(np.float32)
    bd = [rng.randn(n, 2, 16, 16).astype(np.float32) * 2 for _ in range(3)]
    exact = rng.rand(n, 16, 16) < 0.25
    for i in range(3):
        bd[i][:, 0][exact] = bt[:, i][exact]
        bd[i][:, 1][exact] = dire[:, i][exact]
    qt_lab = rng.randint(0, 4, (n, 1, 8, 8)).astype(np.float32)
    qt_out = (qt_lab + rng.randn(n, 1, 8, 8) * (rng.rand(n, 1, 8, 8) < 0.7)).astype(np.float32)
    return [torch.from_numpy(a).to(DEVICE) for a in (qt_out, *bd, qt_lab, bt, dire)]


def loss_and_grads(fn, mode, qp, is_luma, qt_out, bd0, bd1, bd2, qt_lab, bt, dire) -> list:
    """[loss, d/d qt_out (modes q, qbd), d/d bd_i (modes bd, qbd)]."""
    q = qt_out.clone().requires_grad_(mode != "bd")
    b = [x.clone().requires_grad_(mode != "q") for x in (bd0, bd1, bd2)]
    loss = fn(mode, q, b, qt_lab, bt, dire, qp=qp, is_luma=is_luma)
    wrt = ([q] if mode != "bd" else []) + (b if mode != "q" else [])
    return [loss.detach()] + list(torch.autograd.grad(loss, wrt))


def luma_pair_params(seed: int) -> list:
    """The luma Q + BD nets' parameters on the card (92 tensors), drawn from
    flax's initialisation."""
    gen = torch.Generator().manual_seed(seed)
    nets = [init_params(net, gen) for net in (LumaQNet(), LumaMSBDNet())]
    return [p.detach().to(DEVICE) for net in nets for p in net.parameters()]


def adam_case(params: list, seed: int, count: int, zero: bool) -> tuple:
    """(grads, mu, nu) for ``params``: gradients over ten decades with a
    tenth exactly zero; with ``zero`` all gradients and moments zero; else
    moments zero at count 1, seeded as after ``count - 1`` steps above."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    grads = []
    for p in params:
        g = torch.randn(p.shape, generator=gen, device=DEVICE) * \
            10.0 ** (torch.rand(p.shape, generator=gen, device=DEVICE) * 10 - 9)
        g[torch.rand(p.shape, generator=gen, device=DEVICE) < 0.1] = 0
        grads.append(g * 0 if zero else g)
    n = sum(p.numel() for p in params)
    if count == 1 or zero:
        return grads, torch.zeros(n, device=DEVICE), torch.zeros(n, device=DEVICE)
    mu = torch.randn(n, generator=gen, device=DEVICE) * 1e-3
    return grads, mu, mu * mu * torch.rand(n, generator=gen, device=DEVICE) * 4


def train_bounds(name: str, n_items: int, mode: str = "qbd") -> tuple[float, str, int, int]:
    """(bound ms, bound_by, bytes, ops). K11a in ``mode`` on a batch of
    ``n_items``: reads qt_out and its label (64 values each per CTU; modes
    q, qbd), the three branch outputs (512 each) and bt and dire (768 each;
    modes bd, qbd) once, writes the gradients of what it read of qt_out and
    the branches and the loss; about 60 operations per label position of
    the branches, 3 of qt_out. K11b on ``n_items`` parameters: reads p, g,
    mu, nu and writes p, mu, nu (28 B each); 13 operations each."""
    if name == "qbd_loss":
        q, bd = mode != "bd", mode != "q"
        nbytes = n_items * (q * 3 * 64 + bd * (3 * 512 + 2 * 768 + 3 * 512)) * 4 + 4
        ops = n_items * (bd * 256 * 60 + q * 64 * 3)
    else:
        nbytes, ops = 28 * n_items, 13 * n_items
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def k11a_cmp(name: str, got, want, errs: dict) -> None:
    """K11a's outputs ([loss, gradients]) against its plain version's: the
    loss (the 0-d tensor) within TRAIN_LOSS_REL, each gradient within
    TRAIN_GRAD_ULPS of its largest element; the largest absolute error
    into ``errs``."""
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        if g.dim() == 0:
            rel = err / float(w.abs())
            check(rel <= TRAIN_LOSS_REL, f"{name}: loss off by {rel:.3g} relative")
        else:
            bound = TRAIN_GRAD_ULPS * float(np.spacing(np.float32(w.abs().max().item())))
            check(err <= bound, f"{name}: gradient off by {err} (bound {bound})")
        errs[name] = max(errs.get(name, 0.0), err)


def k11a_outputs(mode: str, params, qt_out, bd0, bd1, bd2, qt_lab, bt, dire) -> list:
    """One K11a launch through its wrapper, without autograd: [loss, d/d
    qt_out (modes q, qbd), d/d bd_i (modes bd, qbd)]."""
    loss, g_qt, g_bd = tg._launch_loss(mode, qt_out, (bd0, bd1, bd2), qt_lab, bt, dire, params)
    return [loss] + ([g_qt] if mode != "bd" else []) + (g_bd if mode != "q" else [])


def k11a_call(mode: str, qp: int, is_luma: bool, n: int, seed: int, case=None):
    """(K11a on ``loss_case(n, seed)`` or ``case``, its plain version's
    outputs)."""
    case = loss_case(n, seed) if case is None else case
    params = tg.loss_params(mode, n, qp, is_luma)
    return ((lambda: k11a_outputs(mode, params, *case)),
            loss_and_grads(tg.qbd_loss_reference, mode, qp, is_luma, *case))


K11A_EDGE_CASES = ("TRAIN_LOSS_CASES",
                   "the branch outputs as views off 16 bytes (the scalar instantiation)",
                   "mode q at batch 1: one block in every build", "mode qbd at batch 1",
                   "two calls back to back: the counter back at 0, the second call equal "
                   "to the first bit for bit")


def k11a_edge_calls() -> list:
    """``K11A_EDGE_CASES`` as (call, plain outputs) pairs."""
    calls = [k11a_call(mode, qp, is_luma, n, seed=40 + k)
             for k, (mode, qp, is_luma, n) in enumerate(TRAIN_LOSS_CASES)]
    case = loss_case(TRAIN_BATCH, seed=80)
    views = []
    for b in case[1:4]:
        flat = torch.empty(b.numel() + 1, device=DEVICE)
        views.append(flat[1:].view(b.shape).copy_(b))
    check(all(v.data_ptr() % 16 for v in views), "K11a's edge views are 16-byte aligned")
    calls.append(k11a_call("qbd", 32, False, TRAIN_BATCH, 0, [case[0], *views, *case[4:]]))
    calls.append(k11a_call("q", 22, True, 1, seed=81))
    calls.append(k11a_call("qbd", 37, True, 1, seed=82))
    call, want = k11a_call("qbd", 22, True, 64, seed=83)

    def twice():
        first, second = call(), call()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(first, second)),
              "K11a: two calls back to back differ")
        check(all(int(t) == 0 for t in tg._TICKETS.values()),
              "K11a: a ticket counter is not back at 0")
        return first
    calls.append((twice, want))
    return calls


def k11a_edge_variant_checks() -> list:
    """``K11A_EDGE_CASES`` as one ``VARIANT_CHECKS`` entry."""
    def make():
        calls = k11a_edge_calls()
        return (lambda: [t for c, _ in calls for t in c()]), [t for _, w in calls for t in w]
    return [("K11A_EDGE_CASES", make)]


def profile_k11a_backward(n: int = TRAIN_BATCH, calls: int = 20) -> None:
    """K11a's forward (one launch) and ``_QBDLoss.backward``'s scalings of
    the saved gradients by the incoming one, mode qbd at batch ``n``: device
    time per call of each from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    qt_out, bd0, bd1, bd2, qt_lab, bt, dire = loss_case(n, seed=84)
    q = qt_out.clone().requires_grad_(True)
    b = [x.clone().requires_grad_(True) for x in (bd0, bd1, bd2)]
    step = lambda: torch.autograd.grad(
        tg.qbd_loss("qbd", q, b, qt_lab, bt, dire, qp=22, is_luma=True), [q, *b])
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    if not rows:
        log("[train-kernels] the profiler recorded no device time: K11a's backward scalings "
            "not measured")
        return
    k11a = [(ms, c) for key, ms, c in rows if "qbd_" in key]
    scale = [(ms, c) for key, ms, c in rows if "mul" in key.lower()]
    other = [(key[:60], ms, c) for key, ms, c in rows
             if "qbd_" not in key and "mul" not in key.lower()]
    per = lambda xs: (sum(ms for ms, _ in xs) / calls * 1e3, sum(c for _, c in xs) / calls)
    log(f"[train-kernels] K11a mode qbd, batch {n}, under torch.profiler ({calls} calls): "
        f"forward {per(k11a)[0]:.3f} us in {per(k11a)[1]:g} launch(es) a call; "
        f"_QBDLoss.backward's scalings {per(scale)[0]:.3f} us in {per(scale)[1]:g} "
        f"launch(es) a call; other device work {other}")


def phase_train_kernels() -> tuple[dict, dict]:
    """K11a on ``K11A_EDGE_CASES`` (``TRAIN_LOSS_CASES`` among them) and
    K11b at counts 1 and 1,000 and with zero gradients on the luma Q + BD
    pair's 92 tensors, against their plain versions on the card; K11a twice
    through autograd on ``TRAIN_LOSS_CASES``, bit for bit; then each timed
    at the training path's shapes beside its plain version, K11b beside
    ``torch.optim.Adam(fused=True)``, and K11a's forward beside its
    backward's scalings under the profiler."""
    errs = {"qbd_loss": 0.0, "adam_update": 0.0}
    for k, (mode, qp, is_luma, n) in enumerate(TRAIN_LOSS_CASES):
        case = loss_case(n, seed=40 + k)
        got = loss_and_grads(tg.qbd_loss, mode, qp, is_luma, *case)
        again = loss_and_grads(tg.qbd_loss, mode, qp, is_luma, *case)
        want = loss_and_grads(tg.qbd_loss_reference, mode, qp, is_luma, *case)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K11a {mode} QP{qp}: two runs differ")
        k11a_cmp("qbd_loss", got, want, errs)
        rel = float((got[0] - want[0]).abs() / want[0].abs())
        log(f"[train-kernels] K11a {mode}, QP {qp}, {'luma' if is_luma else 'chroma'}, "
            f"batch {n}: loss {float(want[0]):.6f}, relative error {rel:.3g}; gradients "
            f"within {TRAIN_GRAD_ULPS} ulps; two runs bit-equal")
    for call, want in k11a_edge_calls():
        k11a_cmp("qbd_loss", call(), want, errs)
    torch.cuda.synchronize()
    log(f"[train-kernels] K11a on K11A_EDGE_CASES {K11A_EDGE_CASES}: within "
        f"{TRAIN_LOSS_REL} relative and {TRAIN_GRAD_ULPS} ulps of the plain version")
    params = luma_pair_params(seed=1)
    for count, zero, lr in ((1, False, 1e-3), (1000, False, 2e-4), (2, True, 5e-4)):
        grads, mu, nu = adam_case(params, seed=count, count=count, zero=zero)
        pk, pp = [p.clone() for p in params], [p.clone() for p in params]
        mk, nk, mp, np_ = mu.clone(), nu.clone(), mu.clone(), nu.clone()
        bc = tg.bias_corrections(count)
        tg.adam_update(pk, grads, mk, nk, lr, *bc)
        tg.adam_update_reference(pp, grads, mp, np_, lr, *bc)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(pk + [mk, nk], pp + [mp, np_])),
              f"K11b at count {count} differs from its plain version")
        if zero:
            check(all(torch.equal(a, b) for a, b in zip(pk, params)),
                  "K11b moved a parameter with zero gradient and moments")
        log(f"[train-kernels] K11b, {len(params)} tensors ({mu.numel()} values), count "
            f"{count}, lr {lr}{', zero gradients' if zero else ''}: parameters and "
            f"moments equal to the plain version")

    # times at the training path's shapes: mode qbd, luma, batch 32; Adam on
    # the luma pair (the joint stage's optimizer)
    times = {}
    case = loss_case(TRAIN_BATCH, seed=60)
    lp = tg.loss_params("qbd", TRAIN_BATCH, 22, True)
    qt_out, bd0, bd1, bd2, qt_lab, bt, dire = case
    kernel = lambda: tg._launch_loss("qbd", qt_out, (bd0, bd1, bd2), qt_lab, bt, dire, lp)
    plain = lambda: loss_and_grads(tg.qbd_loss_reference, "qbd", 22, True, *case)
    grads, mu, nu = adam_case(params, seed=7, count=1, zero=False)
    bc = tg.bias_corrections(1)
    lib_params = [p.clone().requires_grad_(True) for p in params]
    for p, g in zip(lib_params, grads):
        p.grad = g.clone()
    lib = torch.optim.Adam(lib_params, lr=1e-3, fused=True, capturable=True)
    adam = {"kernel": lambda: tg.adam_update(params, grads, mu, nu, 1e-3, *bc),
            "plain": lambda: tg.adam_update_reference(params, grads, mu, nu, 1e-3, *bc),
            "library": lib.step}
    for name, n_items, fns in (("qbd_loss", TRAIN_BATCH, (kernel, plain, None)),
                               ("adam_update", int(mu.numel()),
                                (adam["kernel"], adam["plain"], adam["library"]))):
        ms, plain_ms = graph_ms(fns[0]), call_ms(fns[1], 20)
        library_ms = graph_ms(fns[2]) if fns[2] else None
        bound, by, nbytes, ops = train_bounds(name, n_items)
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                           library_ms=library_ms)
        lib_txt = f"; torch.optim.Adam(fused=True) {library_ms:.6f} ms (CUDA graph)" \
            if library_ms is not None else ""
        log(f"[train-kernels] {name}: device time per call (CUDA graph) {ms:.6f} ms; plain "
            f"version from Python {plain_ms:.6f} ms{lib_txt}; bound {bound:.6f} ms by {by} "
            f"({nbytes} B, {ops} ops)")
    profile_k11a_backward()
    return errs, times


def reset_train_counts() -> None:
    for fn, _, _ in TRAIN_KERNELS.values():
        fn.launches = 0


def train_counts() -> dict:
    return {name: fn.launches for name, (fn, _, _) in TRAIN_KERNELS.items()}


def stage_step(stage: str, comp: str, params: dict):
    """(step, batch, nets) of ``stage`` on fresh nets loaded with
    ``params`` ({"q", "bd"} state dicts), a training batch of 32 CTUs."""
    luma = comp == "Luma"
    q_net = (LumaQNet() if luma else ChromaQNet()).to(DEVICE)
    bd_net = (LumaMSBDNet() if luma else ChromaMSBDNet()).to(DEVICE)
    q_net.load_state_dict(params["q"])
    bd_net.load_state_dict(params["bd"])
    if stage == "bd":
        run = make_bd_train_step(bd_net, Adam(bd_net.parameters()), qp=22, is_luma=luma)
    else:
        opt = Adam(list(q_net.parameters()) + list(bd_net.parameters()))
        run = make_qbd_train_step(q_net, bd_net, opt, qp=22, is_luma=luma)
    return run, q_net, bd_net


def phase_train(tmp: pathlib.Path) -> dict:
    """The training path at full width: ``tools/gen_dataset.py``'s label
    search on 512x512 natural content (4 frames to train on, 1 to validate;
    luma at QP 22/27/32/37 in single tree, chroma at QP 22 in dual tree,
    ``phase_rdo_labels``' configuration), then ``tools/train_bd.py`` for
    Luma and Chroma at QP 22: the bd stage from flax's initialisation and the
    qbd stage from the committed ``{comp}_Q_QP22.msgpack``, batch 32; the
    losses per epoch must fall; K11a and K11b launch on every step. Then the
    checkpoints reload through ``CompPredictor.from_trained`` and predict a
    frame through K8, warm steps/s of each stage, and one warm joint step's
    device time split between the nets, K11a and K11b."""
    data, out = tmp / "corpus", tmp / "ckpt"
    t0 = time.perf_counter()
    for split, frames, seed0 in LABEL_SPLITS:
        for chroma in (False, True):
            gen_dataset.main(["--out", str(data), "--frames", str(frames), "--width",
                              str(LABEL_W), "--height", str(LABEL_H), "--qps",
                              "22" if chroma else "22,27,32,37", "--split", split,
                              "--seed0", str(seed0), "--device", DEVICE]
                             + (["--chroma"] if chroma else []))
    tr = {c: load_npy_split(data, "Train", c, 22) for c in ("Luma", "Chroma")}
    hist = {c: np.bincount((tr[c][1] + 1).astype(int).ravel(), minlength=4).tolist()
            for c in tr}
    log(f"[train] labels: {len(tr['Luma'][0])} train + "
        f"{len(load_npy_split(data, 'Validate', 'Luma', 22)[0])} validation CTUs of "
        f"{LABEL_W}x{LABEL_H} natural content, luma QP 22/27/32/37, chroma QP 22, in "
        f"{time.perf_counter() - t0:.3f} s; QP 22 QT depth counts (8x8 units) {hist}")

    reset_train_counts()
    trained, rows = {}, {}
    for comp in ("Luma", "Chroma"):
        t0 = time.perf_counter()
        trained[comp], bd_rows, qbd_rows = train_bd.train_component(
            data, out, comp, 22, bd_epochs=BD_EPOCHS, joint_epochs=JOINT_EPOCHS,
            batch=TRAIN_BATCH, device=DEVICE, print_fn=lambda m: log(f"[train]   {m}"))
        for stage, r in (("bd", bd_rows), ("qbd", qbd_rows)):
            losses = [x["train_loss"] for x in r]
            check(losses[-1] < losses[0], f"{comp} {stage}: the loss did not fall: {losses}")
            rows[(comp, stage)] = losses
        log(f"[train] {comp} QP 22: bd {BD_EPOCHS} epochs, qbd {JOINT_EPOCHS} epochs in "
            f"{time.perf_counter() - t0:.3f} s; loss per epoch bd {rows[(comp, 'bd')]}, "
            f"qbd {rows[(comp, 'qbd')]}")
    launches = train_counts()
    steps = (BD_EPOCHS + JOINT_EPOCHS) * sum(len(tr[c][0]) // TRAIN_BATCH for c in tr)
    check(all(v == steps for v in launches.values()),
          f"launches {launches} against {steps} training steps")
    log(f"[train] launches on the training path {launches}: one of each per step "
        f"({steps} steps)")

    # the checkpoints reload and predict through K8
    for comp in ("Luma", "Chroma"):
        pred = CompPredictor.from_trained(comp == "Luma", out / f"{comp}_Q_QP22.msgpack",
                                          out / f"{comp}_BD_QP22.msgpack", device=DEVICE)
        for net, key in ((pred.q_net, "q"), (pred.bd_net, "bd")):
            check(all(torch.equal(v, trained[comp][key][k].to(DEVICE))
                      for k, v in net.state_dict().items()),
                  f"{comp}: the reloaded {key} net differs from the trained one")
        y, u, v = natural_frame(LABEL_W, LABEL_H, 3000, bit_depth=10)
        blocks = blocks_for_sequence((y >> 2).astype(np.uint8)[None],
                                     (u >> 2).astype(np.uint8)[None],
                                     (v >> 2).astype(np.uint8)[None])
        structural_vote.launches = 0
        qt, bt, dire = pred.predict(blocks[0 if comp == "Luma" else 1])
        n = (LABEL_W // 64) * (LABEL_H // 64)
        check(structural_vote.launches > 0 and qt.shape == (n, 8, 8) and
              bt.shape == (n, 3, 16, 16) and np.isfinite(bt).all() and np.isfinite(dire).all()
              and np.isin(qt, (0, 1, 2, 3)).all(), f"{comp}: prediction from the checkpoint")
        log(f"[train] {comp}: the written checkpoints reload equal to the trained nets and "
            f"predict a {LABEL_W}x{LABEL_H} frame through K8 (QT depth counts "
            f"{np.bincount(qt.astype(int).ravel(), minlength=4).tolist()})")

    # warm steps/s per stage, then one warm joint step's device time split
    for comp in ("Luma", "Chroma"):
        x, qt, bt, dire = (torch.from_numpy(np.ascontiguousarray(a[:TRAIN_BATCH])).to(DEVICE)
                           for a in tr[comp])
        for stage in ("bd", "qbd"):
            run, _, _ = stage_step(stage, comp, trained[comp])
            for _ in range(3):
                run(x, qt, bt, dire, 1e-4)
            torch.cuda.synchronize()
            n_steps = 20
            t0 = time.perf_counter()
            for _ in range(n_steps):
                run(x, qt, bt, dire, 1e-4)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            log(f"[train] {comp} stage {stage}, batch {TRAIN_BATCH}: {n_steps / dt:.2f} warm "
                f"steps/s, {n_steps * TRAIN_BATCH / dt:.1f} CTU samples/s")
    profile_train_step(trained["Luma"], tr["Luma"])
    return launches


def profile_train_step(params: dict, data) -> None:
    """One warm luma joint step, batch 32: the device span of each part
    between CUDA events (nets forward, K11a, backward through the nets,
    K11b) and, under torch.profiler, device time by kernel class and the
    idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, q_net, bd_net = stage_step("qbd", "Luma", params)
    opt = Adam(list(q_net.parameters()) + list(bd_net.parameters()))
    x, qt, bt, dire = (torch.from_numpy(np.ascontiguousarray(a[:TRAIN_BATCH])).to(DEVICE)
                       for a in data)

    def step(events=None):
        mark = (lambda i: events[i].record()) if events else (lambda i: None)
        mark(0)
        qt_out = q_net(x)
        outs = bd_net(x, qt_out)
        mark(1)
        loss = tg.qbd_loss("qbd", qt_out, outs, qt, bt, dire, qp=22, is_luma=True)
        mark(2)
        grads = torch.autograd.grad(loss, opt.params)
        mark(3)
        opt.step(grads, 1e-4)
        mark(4)

    for _ in range(3):
        step()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    step(events)
    torch.cuda.synchronize()
    parts = [events[i].elapsed_time(events[i + 1]) for i in range(4)]
    log("[train-profile] luma joint step, batch 32, device spans between events: nets "
        f"forward {parts[0]:.3f} ms, K11a {parts[1]:.3f} ms, backward {parts[2]:.3f} ms, "
        f"K11b {parts[3]:.3f} ms (step {sum(parts):.3f} ms)")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    if not rows:
        log("[train-profile] the profiler recorded no device time: not measured")
        return
    busy = sum(r[0] for r in rows)
    classes = collections.Counter()
    for ms, _, name in rows:
        cls = "K11a" if "qbd_" in name else "K11b" if "adam_kernel" in name else \
            "convolutions" if any(k in name.lower() for k in ("conv", "cudnn", "gemm", "xmma",
                                                               "winograd", "fft", "sm90")) \
            else "other (pooling, elementwise, copies)"
        classes[cls] += ms
    log(f"[train-profile] wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, idle share "
        f"{1 - busy / wall_ms:.3f}; " + ", ".join(
            f"{k} {v:.3f} ms ({100 * v / busy:.1f}%)" for k, v in classes.most_common()))
    for ms, count, name in sorted(rows, reverse=True)[:8]:
        log(f"[train-profile]   {ms:9.3f} ms  x{count:<4d} {name[:100]}")


# ---------------------------------------------------------------------------
# The sequential FrameEncoder (K10a-d) and the encode CLI
# ---------------------------------------------------------------------------

SEQ_KERNELS = {  # name: (wrapper, source, the TPU kernel it replaces)
    "seq_intra": (intra_ops.predict_block, "pmp_vvc_tpu_torch/csrc/seq_intra.cu",
                  "pmp_vvc_tpu/ops/intra.py:356"),
    "seq_mip": (mip_ops.predict_mip_all, "pmp_vvc_tpu_torch/csrc/seq_mip.cu",
                "pmp_vvc_tpu/ops/mip.py:75"),
    "seq_tq": (quant_ops.seq_tq, "pmp_vvc_tpu_torch/csrc/seq_tq.cu",
               "pmp_vvc_tpu/ops/transforms.py:68, pmp_vvc_tpu/ops/transforms.py:115, "
               "pmp_vvc_tpu/ops/quant.py:47, pmp_vvc_tpu/ops/quant.py:62"),
    "seq_satd": (dist_ops.satd, "pmp_vvc_tpu_torch/csrc/seq_satd.cu",
                 "pmp_vvc_tpu/ops/distortion.py:86"),
}
# K10e: no path of either package calls sad or sse (the JAX package
# re-exports them only), so their launches on the sequential path are 0
K10E_KERNELS = {
    "seq_sad": (dist_ops.sad, "pmp_vvc_tpu_torch/csrc/seq_dist.cu",
                "pmp_vvc_tpu/ops/distortion.py:99"),
    "seq_sse": (dist_ops.sse, "pmp_vvc_tpu_torch/csrc/seq_dist.cu",
                "pmp_vvc_tpu/ops/distortion.py:105"),
}
# the sequential engine's configuration: the bench's tools (TOOLS[BENCH])
# without sign-data hiding, which dependent quantization excludes, and with
# the three tools only this engine codes
SEQ = "sequential tools"
TOOLS[SEQ] = dict(TOOLS[BENCH], sign_hiding=False, mrl=True, isp=True, dep_quant=True)
# class D, as the bench; one frame (two until phases 29-31 joined the
# script, within the same time limit)
SEQ_W, SEQ_H, SEQ_FRAMES = SMALL_W, SMALL_H, 1
SEQ_LUMA_SIDES = (4, 8, 16, 32, 64)
SEQ_CHROMA_SIDES = (2, 4, 8, 16, 32)
SEQ_QPS = (0, 22, 37, 51)
# K10c's shapes: every MTS pair on square and non-square TUs, DCT-2 at 64,
# and the ISP sub-TUs (1xN, Nx1, 2xN, Nx2)
SEQ_TQ_SHAPES = ((4, 4), (8, 8), (16, 16), (32, 32), (8, 4), (4, 16), (32, 8), (16, 32),
                 (64, 64), (64, 32), (16, 64), (1, 16), (16, 1), (1, 32), (32, 1), (1, 64),
                 (2, 8), (8, 2), (2, 16), (16, 2), (2, 32), (4, 1))
SEQ_TIME_W = SEQ_TIME_H = 16          # the timed block
# Scalar integer operations per output, counted from the kernels' inner
# loops: a K10b upsampled sample (two linear passes) and reduced sample (an
# 8-term product); K10c's quantiser and dequantiser per coefficient (abs,
# product, add, shift, sign, clip); one per multiply-add of a transform;
# K10e's difference, |.| or square, and sum per sample.
OPS_SEQ_QUANT, OPS_DIST = 8, 3


# ---------------------------------------------------------------------------
# K10c's and K10d's edge cases, held exactly to their plain versions
# ---------------------------------------------------------------------------

K10C_EDGE_CASES = ("full-scale residuals at 8 bits", "full-scale residuals at 10 bits",
                   "levels at the 16-bit limits through both inverse clips",
                   "dequantiser shift <= 0", "dequantiser product past 2^31, wrapped in int32",
                   "coefficients on the dead-zone boundary",
                   "a negative sum at a rounding half", "zero-out beyond 32 at 64 (DCT-2)",
                   "zero-out beyond 16 at 32 (DST-7 / DCT-8)")
K10D_EDGE_CASES = ("differences of +-1023", "DC-only tiles",
                   "non-square tile on an integer in float32",
                   "non-square tile next to an integer in float32",
                   "one original for all candidates", "one original per candidate")
# blocks of every VTM tile shape (8x16, 16x8, 4x8, 8x4, 8x8, 4x4, 2x2), one
# candidate and several a warp, a warp per candidate, several warps per
# candidate, and sides that are not powers of two
K10D_EDGE_SHAPES = ((16, 8), (8, 16), (8, 4), (4, 8), (8, 8), (4, 4), (2, 2), (32, 16),
                    (16, 32), (32, 4), (64, 64), (64, 16), (2, 8), (8, 2), (12, 8), (24, 16))
# the shapes whose candidates also come with an original each: one a warp,
# several a warp, several warps a candidate, non-square tiles, 2x2 tiles
K10D_PER_CANDIDATE = ((16, 8), (4, 4), (16, 32), (64, 64), (8, 2), (24, 16))
# the least dequantiser shift at 10 bits, 6 - (t_shift - sqrt2 + qp // 6)
# at internal QP 72-75: -11 on a 1x1 TU (t_shift 5, sqrt2 0), which K10c and
# the JAX dequantiser take (the JAX inverse transform has no 1-point core, so
# its calls stop at the dequantiser), and -10 on TUs of 2 and 4 samples (4 +
# 12). There the product |level * scale << -shift| of a level at the 16-bit
# limit passes 2^31 and wraps in int32, in the JAX package and in K10c
# alike: on the 1x1 TU at QP 72-75, on the 1x2 and 2x1 TUs (scale 102 at QP
# 75) at QP 74-75 (K10C_WRAP_QPS, by TU shape)
K10C_MIN_DEQ_SHIFT = -11
K10C_WRAP_QPS = {(1, 1): (72, 73, 74, 75), (1, 2): (74, 75), (2, 1): (74, 75)}


def _core_or_one(kind: int, n: int) -> np.ndarray:
    """The n-point core of ``kind`` as int64, [[64]] for a side of 1 (the
    uncoded side of an ISP TU)."""
    return np.full((1, 1), 64, np.int64) if n == 1 else tr_ops.core_matrix(kind, n).astype(np.int64)


def _q_params(w: int, h: int, qp: int, bd: int) -> tuple[int, int, int, int, int]:
    """(q_bits, add, qscale, iscale, rshift) of the quantiser at a TU's
    geometry (ops/quant.py)."""
    t_shift, sqrt2 = quant_ops._geom(w, h, bd)
    q_bits = 14 + qp // 6 + t_shift - sqrt2
    return (q_bits, 171 << (q_bits - 9), int(quant_ops.QUANT_SCALES[sqrt2][qp % 6]),
            int(quant_ops.INV_QUANT_SCALES[sqrt2][qp % 6]), 6 - (t_shift - sqrt2 + qp // 6))


def k10c_kinds(w: int, h: int, bd: int) -> list:
    """Kind pairs on a w x h TU: DCT-2 both ways, and an MTS kind on every
    side that takes one (DST-7 across at 8 bits, DCT-8 at 10)."""
    mw, mh = 4 <= w <= 32, 4 <= h <= 32
    a, b = (DST7, DCT8) if bd == 8 else (DCT8, DST7)
    if mw or mh:
        return [(DCT2, DCT2), (a if mw else DCT2, b if mh else DCT2)]
    return [(DCT2, DCT2)]


def k10c_edge_inputs(seed: int = 20) -> list:
    """K10c's edge cases: (case, x (n, h, w) int32, stages, kind_h, kind_v,
    qp, bit depth) calls, each case of K10C_EDGE_CASES in several; few calls,
    since the CPU test compiles the JAX package's stages for each."""
    rng = np.random.RandomState(seed)
    FWD, QUANT, DEQUANT, INV = quant_ops.FWD, quant_ops.QUANT, quant_ops.DEQUANT, quant_ops.INV
    cmin, cmax = quant_ops.COEFF_MIN, quant_ops.COEFF_MAX
    calls = []
    # every shape at both bit depths through the forward transform and the
    # quantiser, DCT-2 at one and the MTS kinds at the other (in turns over
    # the shapes), so that every kind meets both
    for (i, (w, h)), bd in itertools.product(enumerate(SEQ_TQ_SHAPES), (8, 10)):
        M = (1 << bd) - 1
        pairs = k10c_kinds(w, h, bd)
        kh, kv = pairs[(i + bd // 2) % len(pairs)]
        yy, xx = np.mgrid[0:h, 0:w]
        # the signs of a high-frequency basis, whose coefficient is largest
        sv = np.sign(_core_or_one(kv, h)[min(h, 16) - 1])
        sh = np.sign(_core_or_one(kh, w)[min(w, 16) - 1])
        basis = np.where(np.outer(sv, sh) < 0, -M, M)
        pats = [np.full((h, w), M), np.full((h, w), -M), M * (1 - 2 * ((yy + xx) % 2)),
                M * (1 - 2 * (yy % 2)), M * (1 - 2 * (xx % 2)), basis, -basis,
                M * rng.choice([-1, 1], (h, w))]
        calls.append((f"full-scale residuals at {bd} bits", np.stack(pats), FWD | QUANT, kh, kv,
                      4 + 6 * (bd - 8), bd))
    # levels at the limits in the signs of each side's basis at the first
    # sample, so that row 0 of both inverse stages adds up; the second clip
    # needs w >= 32 at 10 bits (a shift of 20 - bd after the first clip)
    for w, h, bd in ((4, 4, 10), (32, 32, 10), (64, 64, 10), (8, 16, 10), (1, 16, 10),
                     (8, 8, 8), (16, 1, 8)):
        for kh, kv in k10c_kinds(w, h, bd):
            s_k = np.outer(np.sign(_core_or_one(kv, h)[:, 0]), np.sign(_core_or_one(kh, w)[:, 0]))
            lev = [np.where(s_k < 0, cmin, cmax), np.where(s_k < 0, cmax, cmin),
                   rng.choice([cmin, cmax], (h, w))]
            calls.append(("levels at the 16-bit limits through both inverse clips",
                          np.stack(lev), DEQUANT | INV, kh, kv, 37, bd))
    # dequantiser shifts of 0, -9 and -10 where the QP allows, down to the
    # least, K10C_MIN_DEQ_SHIFT, on the 1x1 TU (the dequantiser alone there)
    for w, h, bd in ((4, 4, 10), (64, 64, 10), (2, 2, 10), (1, 16, 10), (8, 4, 8), (16, 2, 8),
                     (1, 2, 10), (2, 1, 10), (1, 1, 10)):
        base = 6 - _q_params(w, h, 0, bd)[4]           # t_shift - sqrt2
        for rs, off in ((0, 0), (-9, 5), (-10, 0), (K10C_MIN_DEQ_SHIFT, 0)):
            qp = 6 * (6 - base - rs) + off
            if 0 <= qp <= 63 + 6 * (bd - 8):
                lev = rng.randint(-400, 401, (2, h, w))
                lev[0, 0, 0], lev[1, 0, 0] = cmax, cmin
                calls.append(("dequantiser shift <= 0", lev,
                              DEQUANT if w * h == 1 else DEQUANT | INV, DCT2, DCT2, qp, bd))
    # levels at the 16-bit limits where those shifts' products wrap in int32
    for (w, h), qps in K10C_WRAP_QPS.items():
        lev = np.array([[cmax, cmin], [cmin, cmax], [-cmax, cmax], [cmin, -400]])
        for qp in qps:
            calls.append(("dequantiser product past 2^31, wrapped in int32",
                          lev[:, :w * h].reshape(4, h, w),
                          DEQUANT if w * h == 1 else DEQUANT | INV, DCT2, DCT2, qp, 10))
    # the least |c| of levels 1, 2 and 3 and the value below each, both signs
    for (w, h), qp in itertools.product(((4, 4), (64, 64), (8, 4), (1, 16)), (22, 51)):
        q_bits, add, qscale = _q_params(w, h, qp, 10)[:3]
        cb = [-((add - (m << q_bits)) // qscale) for m in (1, 2, 3)]
        vals = [v for c in cb for v in (c, c - 1, -c, 1 - c)]
        coef = np.resize(np.array(vals), h * w).reshape(1, h, w)
        calls.append(("coefficients on the dead-zone boundary", coef, QUANT, DCT2, DCT2, qp, 10))
    # negative sums at a half: impulses of -1 .. -8 into the forward
    # transform's first stage, DC-only coefficients -1, -3, -17, -33 into
    # the inverse's (shift 7; -17 at the second too), levels of -2^(s-4)
    # and three times that into a dequantiser shift s >= 4 (scale 40)
    for w, h, bd in ((4, 4, 8), (16, 16, 10), (8, 4, 10), (1, 16, 8)):
        imp = np.zeros((8, h, w), np.int64)
        for r in range(8):
            imp[r, 0, 0], imp[r, -1, -1] = -(r + 1), -(2 * r + 3)
        calls.append(("a negative sum at a rounding half", imp, FWD, DCT2, DCT2, 22, bd))
    for w, h, bd in ((4, 4, 10), (32, 32, 10), (8, 2, 8), (1, 16, 10)):
        dc = np.zeros((4, h, w), np.int64)
        dc[:, 0, 0] = (-1, -3, -17, -33)
        calls.append(("a negative sum at a rounding half", dc, INV, DCT2, DCT2, 22, bd))
    for w, h in ((8, 8), (64, 64)):
        qp = 6 * max(0, _q_params(w, h, 0, 10)[4] - 4)
        rs = _q_params(w, h, qp, 10)[4]
        lev = np.zeros((2, h, w), np.int64)
        lev[0, 0, :], lev[1, 0, :] = -(1 << (rs - 4)), -3 * (1 << (rs - 4))
        calls.append(("a negative sum at a rounding half", lev, DEQUANT, DCT2, DCT2, qp, 10))
    # the whole round trip over the zeroed-out coefficients
    for case, w, h, kh, kv in (("zero-out beyond 32 at 64 (DCT-2)", 64, 64, DCT2, DCT2),
                               ("zero-out beyond 32 at 64 (DCT-2)", 64, 32, DCT2, DST7),
                               ("zero-out beyond 32 at 64 (DCT-2)", 16, 64, DCT8, DCT2),
                               ("zero-out beyond 32 at 64 (DCT-2)", 1, 64, DCT2, DCT2),
                               ("zero-out beyond 16 at 32 (DST-7 / DCT-8)", 32, 32, DST7, DCT8),
                               ("zero-out beyond 16 at 32 (DST-7 / DCT-8)", 32, 8, DCT8, DST7),
                               ("zero-out beyond 16 at 32 (DST-7 / DCT-8)", 32, 1, DST7, DCT2)):
        calls.append((case, rng.randint(-1023, 1024, (2, h, w)), quant_ops.ROUND_TRIP, kh, kv,
                      22, 10))
    return [(case, np.ascontiguousarray(x, np.int32), *rest) for case, x, *rest in calls]


def _neg_half(acc: np.ndarray, s: int) -> bool:
    """Whether a negative sum lies exactly at a rounding half of a shift by s."""
    return s > 0 and bool(((acc < 0) & (acc % (1 << s) == 1 << (s - 1))).any())


def k10c_edge_seen(case: str, x: np.ndarray, stages: int, kh: int, kv: int, qp: int,
                   bd: int, outs: np.ndarray) -> bool:
    """Whether this call (its plain outputs ``outs``) shows its case; the
    transform's sums restated in int64 from the cores."""
    h, w = x.shape[-2:]
    ins, v = {}, x.astype(np.int64)
    for st, o in zip([st for st in (1, 2, 4, 8) if stages & st], outs):
        ins[st], v = v, o.astype(np.int64)
    one_d = w == 1 or h == 1
    cmin, cmax = quant_ops.COEFF_MIN, quant_ops.COEFF_MAX
    Th, Tv = _core_or_one(kh, w), _core_or_one(kv, h)
    if case.startswith("full-scale"):
        M = (1 << bd) - 1
        return bool(stages & 1) and int(x.max()) == M and int(x.min()) == -M
    if case.startswith("levels at the 16-bit limits"):
        if 8 not in ins or one_d:
            return False
        e = Tv.T @ ins[8]
        e = (e + 64) >> 7
        r = np.clip(e, cmin, cmax) @ Th
        r = (r + (1 << (19 - bd))) >> (20 - bd)
        return bool(((e < cmin) | (e > cmax)).any() and ((r < cmin) | (r > cmax)).any()
                    and (x == cmin).any() and (x == cmax).any())
    if case.startswith("dequantiser shift"):
        return bool(stages & 4) and _q_params(w, h, qp, bd)[4] <= 0
    if case.startswith("dequantiser product"):
        iscale, rs = _q_params(w, h, qp, bd)[3:]
        exact = np.clip(ins.get(4, np.zeros(1, np.int64)), cmin, cmax) * iscale << max(-rs, 0)
        return bool(stages & 4) and bool((abs(exact) >= 2 ** 31).any())
    if case.startswith("coefficients on the dead-zone"):
        q_bits, add, qscale = _q_params(w, h, qp, bd)[:3]
        c = np.abs(ins.get(2, np.zeros(1, np.int64)))
        lv = (c * qscale + add) >> q_bits
        below = (np.maximum(c - 1, 0) * qscale + add) >> q_bits
        return bool(((lv == 1) & (below == 0) & (c > 0)).any() and ((lv > 1) & (below < lv)).any())
    if case.startswith("a negative sum"):
        seen = False
        if 1 in ins:
            if one_d:
                n, kind = (h, kv) if w == 1 else (w, kh)
                vec = ins[1].reshape(len(x), n)
                seen |= _neg_half(vec @ _core_or_one(kind, n)[:min(n, 32)].T,
                                  n.bit_length() - 1 + bd - 9)
            else:
                seen |= _neg_half(ins[1] @ Th.T, w.bit_length() - 1 + bd - 9)
        if 8 in ins:
            if one_d:
                n, kind = (h, kv) if w == 1 else (w, kh)
                seen |= _neg_half(ins[8].reshape(len(x), n) @ _core_or_one(kind, n), 21 - bd)
            else:
                seen |= _neg_half(Tv.T @ ins[8], 7)
        if 4 in ins:
            iscale, rs = _q_params(w, h, qp, bd)[3:]
            seen |= _neg_half(np.clip(ins[4], cmin, cmax) * iscale, rs)
        return seen
    if case.startswith("zero-out beyond 32"):
        return bool(stages & 1) and ((w == 64 and kh == DCT2) or (h == 64 and kv == DCT2))
    if case.startswith("zero-out beyond 16"):
        return bool(stages & 1) and ((w == 32 and kh != DCT2) or (h == 32 and kv != DCT2))
    raise ValueError(case)


def _hadamard_pairs(th: int, tw: int) -> dict:
    """K10d's non-square tile sums: (a, c) with 0 < a, a + c <= 1023 whose
    th x tw tile of a * (a non-DC Hadamard basis) + c has the sum
    a * n + (c * n >> 2) (n = th * tw), which float32 rounds onto an
    integer ("on") or leaves within one ulp of one ("next") when scaled:
    {"on": [(a, c), ...], "next": [...]}."""
    n, sc = th * tw, np.float32(dist_ops._tile_scale(th, tw))
    a = np.arange(1024)[:, None]
    c = np.arange(1024)[None, :]
    tv = a * n + ((c * n) >> 2)
    p = tv.astype(np.float32) * sc
    r = np.round(p)
    ok = (a + c <= 1023) & (a > 0)
    on = ok & (p == r)
    nxt = ok & (p != r) & (np.abs(p - r) <= np.spacing(np.abs(p)))
    pick = lambda m: [tuple(int(v) for v in ij) for ij in np.argwhere(m)[::97][:6]]  # noqa: E731
    return {"on": pick(on), "next": pick(nxt)}


def k10d_edge_inputs(seed: int = 21) -> list:
    """K10d's edge cases: (org, cur) int32 pairs, for every block shape of
    K10D_EDGE_SHAPES one with one original for all candidates and one with
    an original per candidate; the candidates' differences are +-1023
    everywhere, in random signs and in the signs of each tile's last
    Hadamard basis, DC-only tiles, tiles whose non-square sums land on or
    next to an integer in float32, and random."""
    rng = np.random.RandomState(seed)
    out = []
    for w, h in K10D_EDGE_SHAPES:
        th, tw = dist_ops._tile_shape(w, h)
        ty, tx = np.mgrid[0:h, 0:w]
        tile = (ty // th) * (w // tw) + tx // tw
        basis = (np.outer(dist_ops.hadamard(th)[-1], dist_ops.hadamard(tw)[-1])
                 .astype(np.int64)[ty % th, tx % tw])
        ntiles = int(tile.max()) + 1
        diffs = [np.full((h, w), 1023), np.full((h, w), -1023),
                 1023 * rng.choice([-1, 1], (h, w)), 1023 * basis,
                 rng.randint(-1023, 1024, ntiles)[tile], rng.randint(-1023, 1024, (h, w))]
        if th != tw:
            for kind in ("on", "next"):
                pairs = _hadamard_pairs(th, tw)[kind]
                ac = np.array([pairs[t % len(pairs)] for t in range(ntiles)])
                sg = rng.choice([-1, 1], (ntiles, 2))
                diffs.append(ac[tile, 0] * sg[tile, 0] * basis + ac[tile, 1] * sg[tile, 1])
        d = np.stack(diffs)
        org1 = rng.randint(0, 1024, (h, w))
        orgk = rng.randint(0, 1024, d.shape)
        out.append((np.ascontiguousarray(org1, np.int32), np.ascontiguousarray(org1 - d, np.int32)))
        if (w, h) in K10D_PER_CANDIDATE:
            out.append((np.ascontiguousarray(orgk, np.int32),
                        np.ascontiguousarray(orgk - d, np.int32)))
    return out


def k10d_edge_seen(org: np.ndarray, cur: np.ndarray) -> np.ndarray:
    """How often each K10D_EDGE_CASES case occurs in one call (per
    candidate); the tiles restated with numpy's Hadamard."""
    h, w = cur.shape[-2:]
    th, tw = dist_ops._tile_shape(w, h)
    d = org.astype(np.int64) - cur.astype(np.int64)
    d = np.broadcast_to(d, cur.shape).reshape(-1, h // th, th, w // tw, tw).transpose(0, 1, 3, 2, 4)
    hh, hw_ = dist_ops.hadamard(th).astype(np.int64), dist_ops.hadamard(tw).astype(np.int64)
    coef = np.abs(hh @ d @ hw_.T)
    dc = coef[..., 0, 0]
    tv = coef.sum((-2, -1)) - dc + (dc >> 2)
    k = len(d)
    seen = [(np.abs(d) == 1023).all((1, 2, 3, 4)), (((coef[..., 1:, :].sum((-2, -1))
            + coef[..., 0, 1:].sum(-1)) == 0) & (dc > 0)).any((1, 2))]
    if th != tw:
        p = tv.astype(np.float32) * np.float32(dist_ops._tile_scale(th, tw))
        r = np.round(p)
        seen.append(((p == r) & (tv > 0)).any((1, 2)))
        seen.append(((p != r) & (np.abs(p - r) <= np.spacing(np.abs(p)))).any((1, 2)))
    else:
        seen += [np.zeros(k, bool)] * 2
    seen += [np.full(k, org.size == h * w), np.full(k, org.size != h * w)]
    return np.array([int(c.sum()) for c in seen], np.int64)


def k10c_edge_checks(errs: dict) -> dict:
    """K10c against its plain version on ``k10c_edge_inputs``; {case: calls
    that show it}."""
    seen = collections.Counter()
    for case, x, stages, kh, kv, qp, bd in k10c_edge_inputs():
        xt = torch.from_numpy(x).to(DEVICE)
        kw = dict(kind_h=kh, kind_v=kv, qp=qp, bit_depth=bd)
        want = quant_ops.seq_tq_reference(xt, stages, **kw)
        _cmp("seq_tq", quant_ops.seq_tq(xt, stages, **kw), want, errs)
        seen[case] += k10c_edge_seen(case, x, stages, kh, kv, qp, bd, want.cpu().numpy())
    return {case: seen[case] for case in K10C_EDGE_CASES}


def k10d_edge_checks(errs: dict) -> dict:
    """K10d against its plain version on ``k10d_edge_inputs``; {case:
    candidates that show it}."""
    seen = np.zeros(len(K10D_EDGE_CASES), np.int64)
    for org, cur in k10d_edge_inputs():
        o, c = (torch.from_numpy(a).to(DEVICE) for a in (org, cur))
        _cmp("seq_satd", dist_ops.satd(o, c), dist_ops.satd_reference(o, c), errs)
        seen += k10d_edge_seen(org, cur)
    return dict(zip(K10D_EDGE_CASES, seen.tolist()))


# ---------------------------------------------------------------------------
# K10a's and K10b's edge cases, held exactly to their plain versions
# ---------------------------------------------------------------------------

K10A_EDGE_CASES = ("4-tap sums past the range, clipped", "flat references",
                   "wide angles at 2:1 to 16:1", "the side projection at its clamp",
                   "angular PDPC", "planar and DC with PDPC", "DC of a non-square CU",
                   "sides of 2", "64x64", "a single mode", "repeated modes",
                   "modes out of order", "two CUs with different rows (U and V)", "8 bits")
K10B_EDGE_CASES = ("sizeId 0 (4x4, 32 candidates)", "sizeId 1 (4xN, Nx4, 8x8; 16 candidates)",
                   "sizeId 2 (12 candidates)", "upsampling by 16 across (64x4)",
                   "upsampling by 16 down (4x64)", "a negative first boundary term",
                   "a reduced sample clipped at 0", "a reduced sample clipped at the peak",
                   "8 bits")
# a chroma CU's modes as the sequential encoder lists them: the DM (here
# VER) and the non-DM {PLANAR, VER, HOR, DC} with VER replaced by VDIA
CHROMA_MODES = (50, 0, 66, 18, 1)
ALL_MODES = tuple(range(67))
# planar, DC and every fourth angular with the wide-angle ends: few modes
# (the CPU test compiles the JAX predictor for each) that remap at every
# aspect ratio and cover both orientations, both signs of the angle,
# integer and fractional slopes
SOME_MODES = (0, 1, *range(2, 67, 4), 3, 4, 5, 7, 59, 60, 61, 63, 65)


def k10a_rows(kind: str, n: int, w: int, h: int, bd: int, luma: bool, rng) -> tuple:
    """(top_u, left_u, top_f, left_f) int32 numpy rows of n CUs, the corner
    shared: "random" samples, "alt1" 0 and the peak in turns, "alt2" runs of
    two of each (the 4-tap filters' overshoot), "flat" one value a CU; the
    filtered rows by ``filter_reference_samples`` (luma; chroma's equal the
    unfiltered, which its table never leaves)."""
    M = (1 << bd) - 1
    rows, level = [], rng.randint(0, M + 1, (n, 1))
    for ln in (2 * w + 3, 2 * h + 3):
        if kind == "random":
            r = rng.randint(0, M + 1, (n, ln))
        elif kind == "flat":
            r = np.repeat(level, ln, 1)
        else:
            run = 1 if kind == "alt1" else 2
            ph = rng.randint(0, 2 * run, (n, 1))
            r = M * (((np.arange(ln)[None, :] + ph) // run) % 2)
        rows.append(r.astype(np.int32))
    tu, lu = rows
    lu[:, 0] = tu[:, 0]
    if not luma:
        return tu, lu, tu.copy(), lu.copy()
    tf, lf = intra_ops.filter_reference_samples(torch.from_numpy(tu), torch.from_numpy(lu))
    return tu, lu, tf.int().numpy(), lf.int().numpy()


def k10a_edge_inputs(seed: int = 22) -> list:
    """K10a's edge cases: (case, refs, w, h, modes, luma, bit depth) calls,
    each case of K10A_EDGE_CASES in the calls it names (and in others); few
    calls, since the CPU test compiles the JAX package's predictor for each."""
    rng = np.random.RandomState(seed)
    specs = [("4-tap sums past the range, clipped", "alt2", 1, 16, 16, ALL_MODES, True, 10),
             ("4-tap sums past the range, clipped", "alt1", 1, 8, 4, SOME_MODES, True, 8),
             ("flat references", "flat", 1, 32, 32, SOME_MODES, True, 10),
             ("wide angles at 2:1 to 16:1", "random", 1, 4, 64, SOME_MODES, True, 10),
             ("wide angles at 2:1 to 16:1", "alt2", 1, 64, 4, SOME_MODES, True, 10),
             ("wide angles at 2:1 to 16:1", "random", 1, 2, 32, ALL_MODES, False, 10),
             ("the side projection at its clamp", "random", 1, 8, 4, (19, 34, 49, 33, 35), True,
              10),
             ("angular PDPC", "random", 1, 16, 8, (2, 18, 50, 66, 58, 10), True, 10),
             ("planar and DC with PDPC", "alt2", 1, 4, 4, (0, 1), True, 10),
             ("DC of a non-square CU", "random", 1, 16, 4, (1, 0), True, 10),
             ("sides of 2", "random", 1, 2, 2, ALL_MODES, False, 10),
             ("64x64", "random", 1, 64, 64, SOME_MODES, True, 10),
             ("a single mode", "random", 1, 16, 16, (0,), True, 10),
             ("repeated modes", "random", 1, 8, 16, (66, 0, 66, 1, 34, 2, 0, 1), True, 10),
             ("modes out of order", "random", 1, 32, 16, (66, 18, 1, 50, 0, 2, 34), True, 10),
             ("two CUs with different rows (U and V)", "random", 2, 8, 8, CHROMA_MODES, False, 10),
             ("two CUs with different rows (U and V)", "alt2", 2, 16, 16, CHROMA_MODES, False, 10),
             ("8 bits", "random", 1, 16, 32, SOME_MODES, True, 8)]
    return [(case, k10a_rows(kind, n, w, h, bd, luma, rng), w, h, modes, luma, bd)
            for case, kind, n, w, h, modes, luma, bd in specs]


def _angular_facts(refs, w: int, h: int, modes, luma: bool, bd: int) -> tuple[bool, bool]:
    """(a 4-tap sum past [0, peak], a nonzero tap on a side projection
    index that its clamp to the side's length cut) over the call's angular
    modes, restated from ``predict_block``'s extended reference."""
    tu, lu, tf, lf = (r.astype(np.int64) for r in refs)
    past = clamp = False
    for m in sorted(set(modes)):
        p = intra_ops.mode_params(w, h, m, is_luma=luma)
        if m < 2:
            continue
        main, side = (tf, lf) if p.use_filtered else (tu, lu)
        if not p.is_ver:
            main, side = side, main
        wp, hp = (w, h) if p.is_ver else (h, w)
        dpos = p.angle * (1 + np.arange(hp))
        dint, dfrac = dpos >> 5, dpos & 31
        if luma and p.interpolate_gauss:
            half = dfrac >> 1
            f = np.stack([16 - half, 32 - half, 16 + half, half], -1)
        elif luma:
            f = intra_ops.CHROMA_FILTER[dfrac].astype(np.int64)
        else:
            f = np.stack([0 * dfrac, 64 - 2 * dfrac, 2 * dfrac, 0 * dfrac], -1)
        raw = (np.arange(1, hp + 1) * p.inv_angle + 256) >> 9
        ref = np.concatenate([side[:, np.minimum(raw, hp)[::-1]], main], 1)
        base = hp + dint[:, None] + np.arange(wp)[None, :]
        acc = 0
        for k in range(4):
            idx = np.clip(base + k, 0, ref.shape[1] - 1)
            acc = acc + f[:, None, k] * ref[:, idx]
            cut = (idx < hp) & (raw[np.clip(hp - idx - 1, 0, hp - 1)] > hp) & (f[:, None, k] != 0)
            clamp |= p.angle < 0 and bool(cut.any())
        v = (acc + 32) >> 6
        past |= bool(((v < 0) | (v > (1 << bd) - 1)).any())
    return past, clamp


def k10a_edge_seen(refs, w: int, h: int, modes, luma: bool, bd: int) -> np.ndarray:
    """Which K10A_EDGE_CASES one call shows, as booleans."""
    params = [intra_ops.mode_params(w, h, m, is_luma=luma) for m in modes]
    past, clamp = _angular_facts(refs, w, h, modes, luma, bd)
    flat = all((r == r[:, :1]).all() for r in refs)
    return np.array([
        past, flat, w != h and any(p.pred_mode != p.mode for p in params), clamp,
        any(p.mode >= 2 and p.apply_pdpc for p in params),
        min(w, h) >= 4 and any(p.mode < 2 for p in params),
        w != h and 1 in modes, min(w, h) == 2, w == h == 64, len(modes) == 1,
        len(set(modes)) < len(modes), list(modes) != sorted(modes),
        len(refs[0]) == 2 and not all((r[0] == r[1]).all() for r in refs), bd == 8])


def _mip_reduced_raw(top, left, w: int, h: int, bd: int) -> tuple[np.ndarray, np.ndarray]:
    """(the first boundary term of t = 0 and 1, every reduced sample of
    both before its clip at 0 and the peak), restated from
    ``predict_mip_all_reference``."""
    sid = mip_ops.size_id(w, h)
    red_b = 2 if sid == 0 else 4
    mat = mip_ops._matrices()[sid].astype(np.int64)
    rt = mip_ops._downsample(top[1:1 + w].astype(np.int64), red_b)
    rl = mip_ops._downsample(left[1:1 + h].astype(np.int64), red_b)
    firsts, raws = [], []
    for bdry in (np.concatenate([rt, rl]), np.concatenate([rl, rt])):
        off = bdry[0]
        first = (1 << (bd - 1)) - off if sid < 2 else 0
        vec = np.concatenate([[first], bdry[1:] - off])
        add = (1 << (mip_ops.MIP_SHIFT - 1)) - mip_ops.MIP_OFFSET * vec.sum()
        raws.append(((mat @ (vec[1:] if sid == 2 else vec) + add) >> mip_ops.MIP_SHIFT) + off)
        firsts.append(first)
    return np.array(firsts), np.stack(raws)


def k10b_edge_inputs(seed: int = 23) -> list:
    """K10b's edge cases: (top, left, w, h, bit depth) calls at every size
    class and both 16-fold upsamplings, at 10 and 8 bits in turns, on
    random rows, rows at the peak and at 0 (the top row at the peak, then
    the left) and a step from the peak to 0 along each row; few calls,
    since the CPU test compiles the JAX package's MIP for each."""
    rng = np.random.RandomState(seed)
    out = []
    for i, (w, h) in enumerate(((4, 4), (8, 8), (4, 16), (16, 4), (4, 64), (64, 4), (16, 16),
                                (32, 8), (8, 32), (64, 64))):
        bd = (10, 8)[i % 2]
        M = (1 << bd) - 1
        rows = [(rng.randint(0, M + 1, 2 * w + 3), rng.randint(0, M + 1, 2 * h + 3)),
                (np.full(2 * w + 3, M), np.zeros(2 * h + 3)),
                (np.zeros(2 * w + 3), np.full(2 * h + 3, M)),
                (M * (np.arange(2 * w + 3) < w // 2), M * (np.arange(2 * h + 3) >= h // 2))]
        for top, left in rows:
            left = left.copy()
            left[0] = top[0]
            out.append((np.ascontiguousarray(top, np.int32), np.ascontiguousarray(left, np.int32),
                        w, h, bd))
    return out


def k10b_edge_seen(top, left, w: int, h: int, bd: int) -> np.ndarray:
    """Which K10B_EDGE_CASES one call shows, as booleans."""
    sid = mip_ops.size_id(w, h)
    firsts, raw = _mip_reduced_raw(top, left, w, h, bd)
    return np.array([sid == 0, sid == 1, sid == 2, w == 64 and h == 4, w == 4 and h == 64,
                     bool((firsts < 0).any()), bool((raw < 0).any()),
                     bool((raw > (1 << bd) - 1).any()), bd == 8])


def dev_views(arrays) -> tuple:
    """Numpy arrays as views of one int32 upload at their offsets in it
    (odd ones, off the 16-byte grain), as ``FrameEncoder._refs_dev``
    uploads reference rows."""
    flat = torch.from_numpy(np.concatenate([np.ravel(a) for a in arrays]).astype(np.int32))
    flat = flat.to(DEVICE)
    out, off = [], 0
    for a in arrays:
        out.append(flat[off:off + a.size].view(a.shape))
        off += a.size
    return tuple(out)


def k10a_edge_calls() -> list:
    """(kernel call, plain outputs) of every ``k10a_edge_inputs`` call on
    rows uploaded as the encoder uploads them."""
    calls = []
    for _, refs, w, h, modes, luma, bd in k10a_edge_inputs():
        kw = dict(w=w, h=h, modes=modes, is_luma=luma, bit_depth=bd)
        d = dev_views(refs)
        calls.append((functools.partial(intra_ops.predict_block, *d, **kw),
                      intra_ops.predict_block_reference(*d, **kw)))
    return calls


def k10b_edge_calls() -> list:
    """(kernel call, plain outputs) of every ``k10b_edge_inputs`` call, the
    rows uploaded as the encoder uploads them."""
    calls = []
    for top, left, w, h, bd in k10b_edge_inputs():
        t, lft = dev_views((top, left))
        kw = dict(w=w, h=h, bit_depth=bd)
        calls.append((functools.partial(mip_ops.predict_mip_all, t, lft, **kw),
                      mip_ops.predict_mip_all_reference(t, lft, **kw)))
    return calls


def k10a_edge_checks(errs: dict) -> dict:
    """K10a against its plain version on ``k10a_edge_inputs``; {case: calls
    that show it}."""
    for call, want in k10a_edge_calls():
        _cmp("seq_intra", call(), want, errs)
    seen = sum(k10a_edge_seen(*args[1:]).astype(np.int64) for args in k10a_edge_inputs())
    return dict(zip(K10A_EDGE_CASES, seen.tolist()))


def k10b_edge_checks(errs: dict) -> dict:
    """K10b against its plain version on ``k10b_edge_inputs``; {case: calls
    that show it}."""
    for call, want in k10b_edge_calls():
        _cmp("seq_mip", call(), want, errs)
    seen = sum(k10b_edge_seen(*args).astype(np.int64) for args in k10b_edge_inputs())
    return dict(zip(K10B_EDGE_CASES, seen.tolist()))


def seq_refs(n: int, w: int, h: int, bd: int, luma: bool, rng) -> tuple:
    """(top_u, left_u, top_f, left_f) int32 rows of n blocks on the card:
    random samples, the corner shared, the filtered rows from
    ``filter_reference_samples`` (luma; chroma predicts from the unfiltered)."""
    tu = rng.randint(0, 1 << bd, (n, 2 * w + 3)).astype(np.int32)
    lu = rng.randint(0, 1 << bd, (n, 2 * h + 3)).astype(np.int32)
    lu[:, 0] = tu[:, 0]
    tu_t, lu_t = (torch.from_numpy(a).to(DEVICE) for a in (tu, lu))
    tf_t, lf_t = intra_ops.filter_reference_samples(tu_t, lu_t) if luma else (tu_t, lu_t)
    return tuple(t.int().contiguous() for t in (tu_t, lu_t, tf_t, lf_t))


def seq_tq_input(stages: int, w: int, h: int, n: int, rng) -> torch.Tensor:
    """K10c's input for a stage mask: residuals where the forward transform
    runs first, else coefficients, levels or dequantised coefficients."""
    first = stages & -stages
    lim = {quant_ops.FWD: 1023, quant_ops.QUANT: 30000, quant_ops.DEQUANT: 400,
           quant_ops.INV: 30000}[first]
    return torch.from_numpy(rng.randint(-lim, lim + 1, (n, h, w)).astype(np.int32)).to(DEVICE)


def seq_bounds(name: str, w: int, h: int, k: int, stages: int = quant_ops.ROUND_TRIP,
               kinds: tuple = (DCT2, DCT2), n: int = 1,
               luma: bool = True) -> tuple[float, str, int, int]:
    """(bound ms, bound_by, bytes, ops) of one timed K10 call on a w x h
    block: K10a predicts k modes of each of n blocks from their four
    reference rows (chroma from its two unfiltered ones); K10b all k
    candidates; K10c the stages of ``stages`` on k TUs of ``kinds``
    (horizontal, vertical), every stage's output written: a multiply-add
    for each kept coefficient's forward sum, for each residual's inverse
    sum over the whole side, OPS_SEQ_QUANT operations a quantised or
    dequantised coefficient; K10d k SATDs of the block's tiles (log2 of the
    tile's samples butterfly stages, abs and sum a sample); K10e k sums of
    |difference| or its square against n originals (1 or k). Inputs read
    once, outputs written once."""
    hw = w * h
    if name == "seq_intra":
        rows = 2 if luma else 1
        nbytes = n * (4 * rows * (2 * w + 3 + 2 * h + 3) + 4 * k * hw)
        ops = n * k * hw * OPS_PRED
    elif name == "seq_mip":
        rp = 4 if mip_ops.size_id(w, h) < 2 else 8
        nbytes = 4 * (2 * w + 3 + 2 * h + 3) + 4 * k * hw
        ops = k * (hw * OPS_UPSAMPLE + rp * rp * OPS_REDUCED)
    elif name == "seq_tq":
        keep = lambda kind, n: min(n, 32 if kind == DCT2 else 16)  # noqa: E731
        if w == 1 or h == 1:
            n = hw
            fwd, inv = keep(kinds[1] if w == 1 else kinds[0], n) * n, n * n
        else:
            kw, kh = keep(kinds[0], w), keep(kinds[1], h)
            fwd, inv = h * kw * w + kh * kw * h, hw * (h + w)
        nbytes = 4 * k * hw * (1 + bin(stages).count("1"))
        ops = k * (fwd * bool(stages & quant_ops.FWD) + inv * bool(stages & quant_ops.INV)
                   + OPS_SEQ_QUANT * hw * (bool(stages & quant_ops.QUANT)
                                           + bool(stages & quant_ops.DEQUANT)))
    elif name == "seq_satd":
        th, tw = dist_ops._tile_shape(w, h)
        nbytes = 4 * hw + 4 * k * hw + 4 * k
        ops = k * hw * ((th * tw).bit_length() - 1 + 2)
    else:
        nbytes, ops = 4 * n * hw + 4 * k * hw + 4 * k, k * hw * OPS_DIST
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_rate(name)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def host_round_trip_ms(fn, iters: int = 200) -> float:
    """Host time per call of ``fn`` from numpy inputs to numpy outputs (the
    upload, the launch and the read-back with its wait), as the encoder
    calls the kernels."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def k10e_inputs(rng) -> list:
    """(org, cur) int32 pairs on the card for K10e: a 64x64 block of
    differences of 1023 (its int32 sse wraps) first; random samples at
    every side 2..64 against one original and against one per block;
    differences at the int32 limits, which wrap; then inputs for the scalar
    instantiation: views 4 bytes past the 16-byte grain (67 blocks of 16x16
    against one original, 64x64 in two rounds of a 32-warp thread block,
    64x32, an aligned original against an unaligned block, the int32
    limits), and 3x5 blocks on a warp, whose 15 samples are no multiple of
    4."""
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(DEVICE)  # noqa: E731

    def off_grain(a):
        flat = torch.zeros(a.size + 1, dtype=torch.int32, device=DEVICE)
        flat[1:] = dev(a).flatten()
        return flat[1:].view(a.shape)

    pairs = [(dev(np.full((64, 64), 1023)), dev(np.zeros((1, 64, 64))))]
    for w, h in itertools.product((2, 4, 8, 16, 32, 64), repeat=2):
        cur = rng.randint(0, 1024, (3, h, w))
        pairs.append((dev(rng.randint(0, 1024, (h, w))), dev(cur)))
        pairs.append((dev(rng.randint(0, 1024, (3, h, w))), dev(cur)))
    lim = np.iinfo(np.int32)
    pairs.append((dev(rng.choice([lim.max, lim.min, 0, 1], (2, 8, 8))),
                  dev(rng.choice([lim.max, lim.min, -1, 5], (2, 8, 8)))))
    block = lambda *shape: rng.randint(0, 1024, shape)  # noqa: E731
    pairs += [(off_grain(block(16, 16)), off_grain(block(67, 16, 16))),
              (off_grain(block(2, 64, 64)), off_grain(block(2, 64, 64))),
              (off_grain(np.full((64, 32), 1023)), off_grain(np.zeros((3, 64, 32)))),
              (dev(block(32, 32)), off_grain(block(5, 32, 32))),
              (dev(block(5, 3)), dev(block(4, 5, 3))),
              (off_grain(rng.choice([lim.max, lim.min, 0, 1], (2, 8, 8))),
               off_grain(rng.choice([lim.max, lim.min, -1, 5], (2, 8, 8))))]
    check(all(c.data_ptr() % 16 for _, c in pairs[-6:-2]),
          "K10e's scalar inputs lie on the 16-byte grain")
    return pairs


def phase_seq_kernels() -> tuple[dict, dict]:
    """K10a-e against their plain versions on the card, exactly: K10a on all
    67 modes at every luma size 4..64 and chroma size 2..32 (sides of 2
    included) at 8 and 10 bits; K10b at every size class; K10c on every MTS
    pair, DCT-2 at 64 and the ISP shapes at QP 0/22/37/51 (the fused round
    trip) and with every stage mask, and on ``K10C_EDGE_CASES``; K10d on
    every tile shape and on ``K10D_EDGE_CASES``; K10a and K10b on
    ``K10A_EDGE_CASES`` / ``K10B_EDGE_CASES`` with their rows at odd
    offsets of one upload; K10c's and K10d's wrappers refusing
    inputs off the 16-byte grain; K10e on ``k10e_inputs``. Then each
    kernel's device time per call at 16x16 (a CUDA graph of 50 calls), its
    plain version's and the wrapper's round trip from numpy to numpy, and
    ``sad``'s library yardstick (``sad_cdist_ms``)."""
    rng = np.random.RandomState(10)
    errs = dict.fromkeys([*SEQ_KERNELS, *K10E_KERNELS], 0.0)
    n_checked = dict.fromkeys(errs, 0)
    modes = tuple(range(67))
    for luma, sides in ((True, SEQ_LUMA_SIDES), (False, SEQ_CHROMA_SIDES)):
        for w, h, bd in itertools.product(sides, sides, (8, 10)):
            refs = seq_refs(2, w, h, bd, luma, rng)
            kw = dict(w=w, h=h, modes=modes, is_luma=luma, bit_depth=bd)
            _cmp("seq_intra", intra_ops.predict_block(*refs, **kw),
                 intra_ops.predict_block_reference(*refs, **kw), errs)
            n_checked["seq_intra"] += 1
    for (w, h), bd in itertools.product(((4, 4), (4, 8), (8, 4), (8, 8), (4, 16), (16, 4),
                                         (16, 16), (32, 8), (8, 32), (64, 64), (64, 16)),
                                        (8, 10)):
        top, left = (r[0] for r in seq_refs(1, w, h, bd, False, rng)[:2])
        kw = dict(w=w, h=h, bit_depth=bd)
        _cmp("seq_mip", mip_ops.predict_mip_all(top, left, **kw),
             mip_ops.predict_mip_all_reference(top, left, **kw), errs)
        n_checked["seq_mip"] += 1
    kinds = (DCT2, DST7, DCT8)
    for w, h in SEQ_TQ_SHAPES:
        for kh, kv in itertools.product(kinds, kinds):
            if (kh != DCT2 and not 4 <= w <= 32) or (kv != DCT2 and not 4 <= h <= 32):
                continue
            for qp, stages in [(qp, quant_ops.ROUND_TRIP) for qp in SEQ_QPS] + \
                    [(37, m) for m in range(1, 16)]:
                x = seq_tq_input(stages, w, h, 2, rng)
                kw = dict(kind_h=kh, kind_v=kv, qp=qp, bit_depth=BD)
                _cmp("seq_tq", quant_ops.seq_tq(x, stages, **kw),
                     quant_ops.seq_tq_reference(x, stages, **kw), errs)
                n_checked["seq_tq"] += 1
    tiles = set()
    for w, h in ((16, 8), (8, 16), (8, 4), (4, 8), (8, 8), (4, 4), (2, 2), (64, 64), (32, 8),
                 (4, 16), (64, 32), (2, 8), (8, 2), (16, 64)):
        tiles.add(dist_ops._tile_shape(w, h))
        org = torch.from_numpy(rng.randint(0, 1024, (h, w)).astype(np.int32)).to(DEVICE)
        cur = torch.from_numpy(rng.randint(0, 1024, (67, h, w)).astype(np.int32)).to(DEVICE)
        _cmp("seq_satd", dist_ops.satd(org, cur), dist_ops.satd_reference(org, cur), errs)
        n_checked["seq_satd"] += 1
    check(tiles == {(8, 16), (16, 8), (4, 8), (8, 4), (8, 8), (4, 4), (2, 2)},
          f"K10d tile shapes checked: {sorted(tiles)}")
    # K10a's and K10b's edge calls pass their rows as the encoder does,
    # views at odd offsets of one upload, which both wrappers must take
    for kernel, cases, seen in (("K10c", K10C_EDGE_CASES, k10c_edge_checks(errs)),
                                ("K10d", K10D_EDGE_CASES, k10d_edge_checks(errs)),
                                ("K10a", K10A_EDGE_CASES, k10a_edge_checks(errs)),
                                ("K10b", K10B_EDGE_CASES, k10b_edge_checks(errs))):
        missing = [c for c in cases if not seen[c]]
        check(not missing, f"{kernel}'s edge cases not reached: {missing}")
        log(f"[seq-kernels] {kernel} equal to its plain version on its edge cases "
            f"(calls or candidates that show each: {seen})")
    # both wrappers read vectors of 4: inputs off the 16-byte grain are
    # refused before any launch
    odd = torch.zeros(257, dtype=torch.int32, device=DEVICE)[1:].view(16, 16)
    for fn, args in ((quant_ops.seq_tq, (odd, quant_ops.FWD)), (dist_ops.satd, (odd, odd[None]))):
        try:
            fn(*args)
            refused = ""
        except ValueError as e:
            refused = str(e)
        check("16-byte aligned" in refused,
              f"{fn.__name__} did not refuse an input off the 16-byte grain ({refused!r})")
    pairs = k10e_inputs(rng)
    for org, cur in pairs:
        for name, (kernel, _, _) in K10E_KERNELS.items():
            plain = dist_ops.sad_reference if name == "seq_sad" else dist_ops.sse_reference
            _cmp(name, kernel(org, cur), plain(org, cur), errs)
            n_checked[name] += 1
    torch.cuda.synchronize()
    log(f"[seq-kernels] K10a-e equal to their plain versions on the card (max_abs_err "
        f"{errs}; calls checked {n_checked}); K10e's 64x64 block of differences of 1023 "
        f"has sse {int(dist_ops.sse(*pairs[0])[0])} (the int32 sum wraps)")

    # times at 16x16: K10a's 67 modes (luma), K10b's 12 candidates, K10c's
    # fused DCT-2 round trip at QP 37, K10d's 67 SATDs
    w, h = SEQ_TIME_W, SEQ_TIME_H
    refs = seq_refs(1, w, h, BD, True, rng)
    refs_np = [r.cpu().numpy() for r in refs]
    res = seq_tq_input(quant_ops.ROUND_TRIP, w, h, 1, rng)[0]
    res_np = res.cpu().numpy()
    org = torch.from_numpy(rng.randint(0, 1024, (h, w)).astype(np.int32)).to(DEVICE)
    cur = intra_ops.predict_block(*refs, w=w, h=h, modes=modes, bit_depth=BD)[0]
    org_np, cur_np = org.cpu().numpy(), cur.cpu().numpy()
    tq_kw = dict(kind_h=DCT2, kind_v=DCT2, qp=37, bit_depth=BD)
    up = lambda a: torch.from_numpy(a).to(DEVICE)  # noqa: E731
    cases = {
        "seq_intra": (len(modes),
                      lambda: intra_ops.predict_block(*refs, w=w, h=h, modes=modes, bit_depth=BD),
                      lambda: intra_ops.predict_block_reference(*refs, w=w, h=h, modes=modes,
                                                                bit_depth=BD),
                      lambda: intra_ops.predict_block(*(up(a) for a in refs_np), w=w, h=h,
                                                      modes=modes, bit_depth=BD).cpu().numpy()),
        "seq_mip": (2 * mip_ops.num_modes(w, h),
                    lambda: mip_ops.predict_mip_all(refs[0][0], refs[1][0], w=w, h=h,
                                                    bit_depth=BD),
                    lambda: mip_ops.predict_mip_all_reference(refs[0][0], refs[1][0], w=w, h=h,
                                                              bit_depth=BD),
                    lambda: mip_ops.predict_mip_all(up(refs_np[0][0]), up(refs_np[1][0]), w=w,
                                                    h=h, bit_depth=BD).cpu().numpy()),
        "seq_tq": (1, lambda: quant_ops.seq_tq(res, quant_ops.ROUND_TRIP, **tq_kw),
                   lambda: quant_ops.seq_tq_reference(res, quant_ops.ROUND_TRIP, **tq_kw),
                   lambda: quant_ops.seq_tq(up(res_np), quant_ops.ROUND_TRIP,
                                            **tq_kw).cpu().numpy()),
        "seq_satd": (len(modes), lambda: dist_ops.satd(org, cur),
                     lambda: dist_ops.satd_reference(org, cur),
                     lambda: dist_ops.satd(up(org_np), up(cur_np)).cpu().numpy()),
        # K10e on the same 67 candidates
        "seq_sad": (len(modes), lambda: dist_ops.sad(org, cur),
                    lambda: dist_ops.sad_reference(org, cur),
                    lambda: dist_ops.sad(up(org_np), up(cur_np)).cpu().numpy()),
        "seq_sse": (len(modes), lambda: dist_ops.sse(org, cur),
                    lambda: dist_ops.sse_reference(org, cur),
                    lambda: dist_ops.sse(up(org_np), up(cur_np)).cpu().numpy()),
    }
    times = {}
    for name, (k, kernel, plain, host) in cases.items():
        bound, by, nbytes, ops = seq_bounds(name, w, h, k)
        ms, plain_ms, host_ms = graph_ms(kernel), call_ms(plain, 20), host_round_trip_ms(host)
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
        log(f"[seq-kernels] {name} at {w}x{h} ({k} outputs): device time per call (CUDA "
            f"graph of 50) {ms:.6f} ms; plain version from Python {plain_ms:.6f} ms; wrapper "
            f"round trip numpy to numpy {host_ms:.6f} ms; bound {bound:.6f} ms by {by} "
            f"({nbytes} B, {ops} ops)")
    times["seq_sad"]["library_ms"] = sad_cdist_ms(org, cur)
    return errs, times


def sad_cdist_ms(org: torch.Tensor, cur: torch.Tensor) -> float:
    """K10e's library yardstick: ``torch.cdist(p=1)`` on float32 copies of
    the blocks (made outside the timed calls) computes the same SADs
    exactly, every term and partial sum an integer below 2^24; its device
    time per call (CUDA graph of 50). ``sse`` has no such call (``cdist``
    with p=2 takes a square root)."""
    cur_f = cur.reshape(cur.shape[0], -1).float()
    org_f = org.reshape(1, -1).float()
    lib = lambda: torch.cdist(cur_f, org_f, p=1)  # noqa: E731
    got = lib()[:, 0]
    check(org_f.shape[1] * 1023 < 1 << 24 and
          torch.equal(got.int(), dist_ops.sad(org, cur)), "cdist(p=1) differs from K10e's sad")
    ms = graph_ms(lib)
    log(f"[seq-kernels] seq_sad's library yardstick, torch.cdist(p=1) on float32 copies of "
        f"{cur.shape[0]} blocks of {cur.shape[-1]}x{cur.shape[-2]}: equal SADs, device time per "
        f"call (CUDA graph of 50) {ms:.6f} ms")
    return ms


# the stage mask of each name under which codec/encoder.py calls K10c (None:
# ``seq_tq`` itself, whose second argument is the mask)
SEQ_TQ_NAMES = {"seq_tq": None, "forward_transform": quant_ops.FWD,
                "quantize": quant_ops.QUANT, "dequantize": quant_ops.DEQUANT,
                "inverse_transform": quant_ops.INV}


def _counted_module(module, name: str, key, mix: collections.Counter):
    """``module`` as a namespace whose ``name`` adds ``key(*args, **kw)``
    to ``mix`` and then calls the module's function; every other name is
    the module's. The function itself is untouched, so its launch count,
    which it keeps through its own module's name, still counts."""
    fn = getattr(module, name)

    def call(*args, **kw):
        mix[key(*args, **kw)] += 1
        return fn(*args, **kw)
    return types.SimpleNamespace(**{**vars(module), name: call})


def _k10a_key(tu, *args, w, h, modes, is_luma=True, **kw):
    return (w, h, len(modes), is_luma, tu.shape[0])


@contextlib.contextmanager
def seq_call_mix(*modules):
    """The K10 calls of ``modules`` (default: the sequential encoder's,
    ``codec/encoder.py``; the decoder's ``codec/decoder.py`` beside it)
    counted through the names they call them by, the wrappers and their
    launch counts unchanged: K10a's by (w, h, modes, luma, blocks), K10b's
    by (w, h), K10c's by (stage mask, w, h, kind_h, kind_v), K10d's by (w,
    h, candidates); yields {"k10a": Counter, ...}. The modules reach K10a
    and K10b through their ``intra_ops`` and ``mip_ops``, which they then
    see as ``_counted_module`` namespaces. The quantiser and dequantiser
    alone take no kind: DCT-2 stands for it."""
    modules = modules or (seq_enc,)
    mixes = {k: collections.Counter() for k in ("k10a", "k10b", "k10c", "k10d")}
    tq_mix, satd_mix = mixes["k10c"], mixes["k10d"]

    def tq_counted(fn, mask):
        sig = inspect.signature(fn)

        def call(x, *args, **kw):
            a = sig.bind(x, *args, **kw).arguments
            tq_mix[(a["stages"] if mask is None else mask, x.shape[-1], x.shape[-2],
                    a.get("kind_h", DCT2), a.get("kind_v", DCT2))] += 1
            return fn(x, *args, **kw)
        return call

    def satd_counted(org, cur, **kw):
        h, w = cur.shape[-2:]
        satd_mix[(w, h, cur.numel() // (h * w))] += 1
        return dist_ops.satd(org, cur, **kw)

    counted = {name: tq_counted(getattr(quant_ops, name), mask)
               for name, mask in SEQ_TQ_NAMES.items()}
    counted.update(
        satd=satd_counted,
        intra_ops=_counted_module(intra_ops, "predict_block", _k10a_key, mixes["k10a"]),
        mip_ops=_counted_module(mip_ops, "predict_mip_all",
                                lambda *a, w, h, **kw: (w, h), mixes["k10b"]))
    saved = [(module, name, getattr(module, name)) for module in modules
             for name in counted if hasattr(module, name)]
    for module, name, _ in saved:
        setattr(module, name, counted[name])
    try:
        yield mixes
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def k10a_pair_calls(mix: collections.Counter) -> int:
    """K10a's calls in ``mix`` that predicted two blocks (a chroma CU's U and
    V): each stands for two launches of a caller that predicts a plane a
    call."""
    return sum(n for key, n in mix.items() if key[4] == 2)


def seq_encode(enc, frames, maps_l, maps_c) -> list:
    """``enc.encode_frame`` on each frame with its maps."""
    return [enc.encode_frame(y, u, v, maps=maps_l[f], chroma_maps=maps_c[f], poc=f)
            for f, (y, u, v) in enumerate(frames)]


def seq_counts(enc) -> dict:
    return dict(mrl=enc.n_mrl, isp=enc.n_isp, depquant=enc.n_depquant, cclm=enc.n_cclm,
                jccr=enc.n_jccr, lfnst=enc.n_lfnst)


def phase_seq_encode(preds: dict) -> tuple[dict, tuple]:
    """The sequential engine's main path: ``FrameEncoder(mode_select="satd")``
    with all 67 RMD modes on ``SEQ_FRAMES`` 416x240 frames of natural content, the
    sequential configuration (``TOOLS[SEQ]``, dual tree, QP 32) with the
    QP 22 maps, a cold run then a warm one with every K10 kernel's launches
    counted; frames/s and stage times; the MRL and ISP CUs and the
    dependent-quantization TUs (each must occur); hash SEI against the
    recon's MD5 and luma PSNR above 30 dB. The cold run codes the first
    frame only (it loads every kernel). Returns the launches and the warm
    run's (stream, recons)."""
    frames = natural_sequence(SEQ_W, SEQ_H, SEQ_FRAMES, seed0=7, bit_depth=BD)
    maps_l, maps_c = frame_maps(preds, frames, SEQ_W, SEQ_H)
    enc = FrameEncoder(enc_cfg(SEQ_W, SEQ_H, SEQ), mode_select="satd", device=DEVICE)
    t0 = time.perf_counter()
    seq_encode(enc, frames[:1], maps_l, maps_c)
    log(f"[seq-encode] {SEQ_W}x{SEQ_H}, {SEQ}: cold run (1 frame) "
        f"{time.perf_counter() - t0:.3f} s")
    reset_seq_counts()
    enc.timings = {}
    counts = collections.Counter()
    t0 = time.perf_counter()
    outs = []
    with seq_call_mix() as mixes:
        for f, (y, u, v) in enumerate(frames):
            outs.append(enc.encode_frame(y, u, v, maps=maps_l[f], chroma_maps=maps_c[f], poc=f))
            counts.update(seq_counts(enc))
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, (fn, _, _) in SEQ_KERNELS.items()}
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the sequential path")
    launches.update({name: fn.launches for name, (fn, _, _) in K10E_KERNELS.items()})
    for tool in ("mrl", "isp", "depquant"):
        check(counts[tool] > 0, f"{tool} never fired on the sequential path ({dict(counts)})")
    stages = ", ".join(f"{k} {v:.3f}" for k, v in enc.timings.items())
    log(f"[seq-encode] warm run {wall:.3f} s = {SEQ_FRAMES / wall:.4f} frames/s ({stages} s); "
        f"launches {launches}; CUs with MRL {counts['mrl']}, with ISP {counts['isp']}; TUs "
        f"the dependent-quantization trellis gave a level {counts['depquant']}; CCLM CUs "
        f"{counts['cclm']}, joint Cb-Cr TUs {counts['jccr']}, LFNST CUs {counts['lfnst']}")
    for f, (bs, recon) in enumerate(outs):
        want = [hashlib.md5(p.astype("<u2").tobytes()).digest() for p in recon]
        check(sei_md5s(bs) == [want], f"frame {f}: hash SEI differs from the recon's MD5")
        err = (recon[0].astype(np.int64) - frames[f][0]) ** 2
        psnr = 10 * np.log10(1023 * 1023 / err.mean())
        check(psnr > 30, f"frame {f}: luma PSNR {psnr:.2f} dB")
        log(f"[seq-encode] frame {f}: {len(bs)} bytes, luma PSNR {psnr:.3f} dB, hash SEI "
            f"equal to the recon's MD5")
    counted = {TIMED_KERNELS[k][0]: sum(mix.values()) for k, mix in mixes.items()}
    check(all(counted[name] == launches[name] for name in counted),
          f"the call mix ({counted}) is not the launches")
    pairs = k10a_pair_calls(mixes["k10a"])
    log(f"[seq-encode] K10a: {launches['seq_intra']} launches, {pairs} of them a chroma CU's U "
        f"and V in one call ({launches['seq_intra'] + pairs} a call a plane)")
    seq_mix_times(mixes, "[seq-encode]", {"new": None})
    phase_seq_profile(enc, frames[0], maps_l[0], maps_c[0])
    return launches, stream_of(outs)


def mix_modes(m: int) -> tuple:
    """m modes spread over 0..66 (planar first, VDIA last), standing for a
    K10a call's list of that length in the call mix."""
    return tuple(int(v) for v in np.linspace(0, 66, m))


def seq_mix_inputs(key: tuple, name: str, rng):
    """(call, bound ms) of one entry of the sequential path's call mix:
    K10a's (w, h, modes, luma, blocks) on ``mix_modes`` and K10b's (w, h)
    on random rows uploaded as the encoder uploads them, K10c's (stage
    mask, w, h, kind_h, kind_v) on one TU at QP 37, K10d's (w, h,
    candidates) against one original."""
    if name == "seq_intra":
        w, h, m, luma, n = key
        refs, modes = dev_views(k10a_rows("random", n, w, h, BD, luma, rng)), mix_modes(m)
        return ((lambda: intra_ops.predict_block(*refs, w=w, h=h, modes=modes, is_luma=luma,
                                                 bit_depth=BD)),
                seq_bounds(name, w, h, m, n=n, luma=luma)[0])
    if name == "seq_mip":
        w, h = key
        top, left = dev_views([r[0] for r in k10a_rows("random", 1, w, h, BD, False, rng)[:2]])
        return ((lambda: mip_ops.predict_mip_all(top, left, w=w, h=h, bit_depth=BD)),
                seq_bounds(name, w, h, 2 * mip_ops.num_modes(w, h))[0])
    if name == "seq_tq":
        stages, w, h, kh, kv = key
        x = seq_tq_input(stages, w, h, 1, rng)[0]
        kw = dict(kind_h=kh, kind_v=kv, qp=37, bit_depth=BD)
        return ((lambda: quant_ops.seq_tq(x, stages, **kw)),
                seq_bounds(name, w, h, 1, stages, (kh, kv))[0])
    w, h, k = key
    org = torch.from_numpy(rng.randint(0, 1024, (h, w)).astype(np.int32)).to(DEVICE)
    cur = torch.from_numpy(rng.randint(0, 1024, (k, h, w)).astype(np.int32)).to(DEVICE)
    return (lambda: dist_ops.satd(org, cur)), seq_bounds(name, w, h, k)[0]


def seq_mix_times(mixes: dict, tag: str, libs: dict,
                  kernels=("k10a", "k10b", "k10c", "k10d")) -> dict:
    """Every entry of the sequential path's call mixes (``seq_call_mix``)
    of ``kernels`` timed (CUDA graph of 50) with each of ``libs`` ({label:
    library, None for the port's own build} of the kernels they replace) in
    turns; the top entries logged with their bounds, and each label's lost
    time, launches x (time - bound) summed over the mix. {kernel: {label:
    lost ms}}."""
    rng = np.random.RandomState(30)
    out = {}
    for kernel in kernels:
        mix, name = mixes[kernel], TIMED_KERNELS[kernel][0]
        lost = collections.Counter()
        rows = []
        for key, n in mix.most_common():
            call, bound = seq_mix_inputs(key, name, rng)
            ts = {}
            for label, lib in libs.items():
                with launching(kernel, lib):
                    ts[label] = graph_ms(call)
                lost[label] += n * (ts[label] - bound)
            rows.append((key, n, bound, ts))
        for key, n, bound, ts in rows[:12]:
            log(f"{tag} {name} {key}: {n} launches, bound {bound * 1e3:.4f} us, per call "
                + "; ".join(f"{label} {t * 1e3:.3f} us" for label, t in ts.items()))
        log(f"{tag} {name}: {sum(mix.values())} launches in {len(mix)} shapes; lost time "
            f"(launches x (time - bound)) " + "; ".join(f"{label} {ms:.4f} ms"
                                                       for label, ms in lost.items()))
        out[kernel] = dict(lost)
    return out


def phase_seq_profile(enc, frame, maps_l, maps_c) -> None:
    """One more warm encode of the first frame under torch.profiler (device
    kernels only) and cProfile at once: the device's busy time and idle
    share, and the host functions taking the most time of their own (both
    profilers' overhead included in the wall time)."""
    import cProfile
    import pstats
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    host = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        host.enable()
        enc.encode_frame(*frame, maps=maps_l, chroma_maps=maps_c)
        host.disable()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    if rows:
        log(f"[seq-profile] one {SEQ_W}x{SEQ_H} frame: wall {wall_ms:.3f} ms (profiled), "
            f"device busy {busy:.3f} ms, idle share {1 - busy / wall_ms:.5f}")
        for ms, count, name in rows[:6]:
            log(f"[seq-profile]   {ms:9.3f} ms  x{count:<6d} {name[:90]}")
    else:
        log("[seq-profile] the profiler recorded no device time: not measured")
    stats = pstats.Stats(host)
    total = sum(v[2] for v in stats.stats.values())
    top = sorted(((v[2], v[1], f"{pathlib.Path(k[0]).name}:{k[1]}({k[2]})")
                  for k, v in stats.stats.items()), reverse=True)[:12]
    log(f"[seq-profile] host: {total:.3f} s of own time over all functions; the largest:")
    for tt, calls, name in top:
        log(f"[seq-profile]   {tt:8.3f} s {100 * tt / total:5.1f}%  x{calls:<8d} {name[:90]}")


def phase_seq_cpu_vs_card(preds: dict) -> tuple:
    """One 208x120 frame of the sequential configuration with
    ``device="cpu"`` (the plain versions) and on the card: byte-identical.
    Returns the card's (stream, recons)."""
    w, h = SEQ_W // 2, SEQ_H // 2
    frames = natural_sequence(w, h, 1, seed0=7, bit_depth=BD)
    maps_l, maps_c = frame_maps(preds, frames, w, h)
    out = {}
    for device in ("cpu", DEVICE):
        enc = FrameEncoder(enc_cfg(w, h, SEQ), mode_select="satd", device=device)
        t0 = time.perf_counter()
        out[device] = seq_encode(enc, frames, maps_l, maps_c)
        log(f"[seq-cpu-vs-card] {w}x{h}, {SEQ}, on {device}: "
            f"{time.perf_counter() - t0:.3f} s; {seq_counts(enc)}")
    check(out["cpu"][0][0] == out[DEVICE][0][0],
          "sequential encode: CPU and card bitstreams differ")
    log(f"[seq-cpu-vs-card] bitstreams byte-identical ({len(out[DEVICE][0][0])} bytes)")
    return stream_of(out[DEVICE])


def phase_cli(tmp: pathlib.Path) -> dict:
    """``cli.encode.main`` on a 2-frame 8-bit 256x128 YUV with the QP 22
    predictors' MTT maps (``--model-dir``), on the card, with the sequential
    engine (MRL, ISP, dependent quantization among its tools) and the
    wavefront one; each frame's hash SEI equals the MD5 of its recon. Then
    ``cli.decode.main`` on the sequential stream, on the card: exit 0 (every
    hash verified) and an output file equal to the encode's recon file.
    Returns each engine's {"encode CLI, <engine>": (stream, recons)}."""
    w, h = 256, 128
    frames = natural_sequence(w, h, 2, seed0=9, bit_depth=8)
    yuv = tmp / "cli_in.yuv"
    write_yuv420(yuv, *(np.stack([f[i] for f in frames]).astype(np.uint8) for i in range(3)))
    common = ["--input", str(yuv), "--width", str(w), "--height", str(h), "--frames", "2",
              "--qp", "22", "--model-dir", str(CKPT), "--mtt", "--sao", "--mip", "--lfnst",
              "--cclm", "--jccr"]
    engines = {"sequential": ["--mrl", "--isp", "--dep-quant"],
               "wavefront": ["--sign-hiding"]}
    streams = {}
    for engine, extra in engines.items():
        out, rec = tmp / f"cli_{engine}.bin", tmp / f"cli_{engine}.yuv"
        t0 = time.perf_counter()
        cli_encode.main(common + extra + ["--engine", engine, "--output", str(out),
                                          "--recon", str(rec)])
        wall = time.perf_counter() - t0
        bs = out.read_bytes()
        planes = np.fromfile(rec, np.uint16).astype(np.int32)
        n = w * h * 3 // 2
        recons = [(q[:w * h].reshape(h, w), q[w * h:w * h * 5 // 4].reshape(h // 2, w // 2),
                   q[w * h * 5 // 4:].reshape(h // 2, w // 2))
                  for q in (planes[f * n:(f + 1) * n] for f in range(2))]
        want = [[hashlib.md5(q.astype("<u2").tobytes()).digest() for q in r] for r in recons]
        check(sei_md5s(bs) == want, f"CLI {engine}: hash SEI differs from the recon's MD5")
        log(f"[cli] --engine {engine} {' '.join(extra)}: {len(bs)} bytes in {wall:.3f} s, "
            f"hash SEI equal to the recon's MD5")
        streams[f"encode CLI, {engine}"] = (bs, recons)
        if engine == "sequential":
            dec = tmp / "cli_sequential_dec.yuv"
            t0 = time.perf_counter()
            rc = cli_decode.main(["-b", str(out), "-o", str(dec)])
            wall = time.perf_counter() - t0
            check(rc == 0, f"cli.decode: exit {rc} (a hash mismatched)")
            check(dec.read_bytes() == rec.read_bytes(),
                  "cli.decode: the decoded YUV differs from the encode's recon file")
            log(f"[cli] cli.decode.main on the sequential stream, on the card: {wall:.3f} s, "
                f"every hash verified, the YUV equal to the recon file")
    return streams


# ---------------------------------------------------------------------------
# the sequential encoder's RDO split search (K10a-d in its trials) and the
# decoder (K10a-c), on the card
# ---------------------------------------------------------------------------

RDO_SEQ_W, RDO_SEQ_H, RDO_SEQ_QP = 192, 128, 32     # tools/rdcheck.py's frame and QP
# the search phase's one cut: every fourth RMD mode (rdcheck takes all 67)
RDO_SEQ_RMD = tuple(range(0, 67, 4))
RDO_SEQ_SMALL = 64                    # the CPU-against-card frame's side
RDO_SEQ_FB_LEVEL = 0                  # the maps-rd-fb run's accel level (see phase_seq_rdo)


def ctc_cfg(w: int, h: int) -> VVCConfig:
    """``tools/rdcheck.py:ctc_cfg``: dual tree, MTS, LFNST, MIP, MRL, ISP,
    CCLM, joint Cb-Cr, dependent quantization, no SDH; LMCS with chroma
    scaling, SAO, ALF, CC-ALF, deblocking; the CTC chroma QP table; QP 32;
    the other fields ``VVCConfig``'s (luma MTT depth 0, chroma 3)."""
    return VVCConfig(width=w, height=h, qp=RDO_SEQ_QP, dual_tree=True, mts_intra=True,
                     lfnst=True, mip=True, mrl=True, isp=True, cclm=True, joint_cbcr=True,
                     dep_quant=True, sign_hiding=False, lmcs=True, lmcs_chroma_scaling=True,
                     sao=True, alf=True, alf_chroma=True, ccalf=True,
                     deblocking_disabled=False, chroma_qp_start_minus26=-9,
                     chroma_qp_points=((9, 12), (4, 5), (11, 7)))


@contextlib.contextmanager
def rd_searches():
    """``FrameEncoder._rd_search``'s calls, counted: yields {"deferred": the
    nodes the coding pass sent to the search (calls outside any trial),
    "all": every call, the trials' nested ones included, "won": Counter of
    the deferred nodes' winning splits}."""
    out = {"deferred": 0, "all": 0, "won": collections.Counter()}
    search, depth = FrameEncoder._rd_search, [0]

    def counted(self, *args, **kw):
        out["all"] += 1
        out["deferred"] += depth[0] == 0
        depth[0] += 1
        try:
            won = search(self, *args, **kw)
        finally:
            depth[0] -= 1
        if depth[0] == 0:
            out["won"][won.name] += 1
        return won
    FrameEncoder._rd_search = counted
    try:
        yield out
    finally:
        FrameEncoder._rd_search = search


@contextlib.contextmanager
def parsed_splits():
    """The split decisions each decode parses (``FrameDecoder._parse_split``,
    implicit ones too), counted by (tree, split): the coded tree."""
    counts = collections.Counter()
    parse = seq_dec.FrameDecoder._parse_split

    def counted(self, x, y, w, h, state, chroma=False):
        split = parse(self, x, y, w, h, state, chroma)
        counts[("chroma" if chroma else "luma", split.name)] += 1
        return split
    seq_dec.FrameDecoder._parse_split = counted
    try:
        yield counts
    finally:
        seq_dec.FrameDecoder._parse_split = parse


def reset_seq_counts() -> None:
    for fn, _, _ in [*SEQ_KERNELS.values(), *K10E_KERNELS.values()]:
        fn.launches = 0


def k10_launches() -> dict:
    return {name: fn.launches for name, (fn, _, _) in SEQ_KERNELS.items()}


def log_call_mix(tag: str, mixes: dict, top: int = 4) -> None:
    """Each kernel's calls in ``mixes`` (``seq_call_mix``): the total, the
    number of shapes and the most frequent entries."""
    for kernel, mix in mixes.items():
        log(f"{tag} {TIMED_KERNELS[kernel][0]}: {sum(mix.values())} calls in {len(mix)} shapes; "
            + ", ".join(f"{key} x{n}" for key, n in mix.most_common(top)))


def check_frame(tag: str, bs: bytes, recon, org) -> float:
    """Hash SEI against the recon's MD5; the luma PSNR (above 27 dB: QP 32
    in ``ctc_cfg`` gives 28-31 dB on ``natural_frame``)."""
    want = [hashlib.md5(p.astype("<u2").tobytes()).digest() for p in recon]
    check(sei_md5s(bs) == [want], f"{tag}: hash SEI differs from the recon's MD5")
    err = (recon[0].astype(np.int64) - org[0]) ** 2
    psnr = 10 * np.log10(1023 * 1023 / err.mean())
    check(psnr > 27, f"{tag}: luma PSNR {psnr:.2f} dB")
    return psnr


def seq_rdo_run(device: str, side: tuple, mode_select: str, enc_kw: dict,
                frame_kw: dict) -> dict:
    """One encode of phases 29-30: ``natural_frame(w, h, seed=21)`` (``side``
    = (w, h)) in ``ctc_cfg`` over ``RDO_SEQ_RMD`` on ``device``, K10a-d's
    launch counts set to 0 just before it and read just after, with their
    call mix and the search's counts (``rd_searches``). Top-level, so that a
    spawned worker process runs it beside the card's other runs."""
    w, h = side
    frame = natural_frame(w, h, seed=21, bit_depth=BD)
    enc = FrameEncoder(ctc_cfg(w, h), mode_select=mode_select, rmd_modes=RDO_SEQ_RMD,
                       device=device, **enc_kw)
    reset_seq_counts()
    with seq_call_mix() as mixes, rd_searches() as searches:
        t0 = time.perf_counter()
        bs, recon = enc.encode_frame(*frame, **frame_kw)
        wall = time.perf_counter() - t0
    return dict(bs=bs, recon=recon, frame=frame, wall=wall, timings=dict(enc.timings),
                launches=k10_launches(), mixes=mixes, searches=searches, counts=seq_counts(enc))


@contextlib.contextmanager
def phase_seq_rdo(preds: dict):
    """Phases 29 and 30, the sequential encoder's RDO split search.

    29: ``natural_frame(192, 128, seed=21)`` (``tools/rdcheck.py``'s size)
    in ``ctc_cfg`` with ``mode_select="rd"`` over ``RDO_SEQ_RMD``, on the
    card: ``encode_frame(rdo=True)`` (rdcheck's "rdo") and the QP 22
    predictors' maps with ``rdo_fallback=True`` ("maps-rd-fb") at accel
    level ``RDO_SEQ_FB_LEVEL``: 0, since at rdcheck's L3, and at L2 and L1,
    these maps defer no node of this frame (``ctc_cfg``'s luma tree has MTT
    depth 0, so every luma node is inside the map gate, and the chroma maps
    reach MTT depth 2 nowhere). Each run: host seconds and
    ``timings["code"]``, K10a-d's launches (each must launch) and call mix,
    the deferred nodes (some must be) with their winning splits and the
    search's calls in all, bits, luma PSNR, the hash SEI against the
    recon's MD5.

    30: ``natural_frame(64, 64, seed=21)`` in ``ctc_cfg`` with
    ``mode_select="satd"``, ``encode_frame(rdo=True)`` and the QP 22 maps
    with ``rdo_fallback`` at accel level 0, with ``device="cpu"`` (the
    plain versions) and on the card: byte-identical, nodes deferred.

    The runs are host-bound and the card idles through them, so they go to
    three spawned worker processes (``rdo=True``, maps-rd-fb, phase 30's
    four in turn) while the body of the ``with`` runs other phases; each
    run's host seconds are taken beside the others'. On leaving the block
    the runs are checked and logged, and the yielded dict gains "streams"
    ({label: (stream, recons)} of the card's runs) and "launches" ({label:
    launches} of phase 29's)."""
    w, h, s = RDO_SEQ_W, RDO_SEQ_H, RDO_SEQ_SMALL
    maps_l, maps_c = frame_maps(preds, [natural_frame(w, h, seed=21, bit_depth=BD)], w, h)
    small_l, small_c = frame_maps(preds, [natural_frame(s, s, seed=21, bit_depth=BD)], s, s)
    runs = {  # label: (device, side, mode_select, enc_kw, frame_kw)
        "rdo": (DEVICE, (w, h), "rd", {}, dict(rdo=True)),
        "maps-rd-fb": (DEVICE, (w, h), "rd",
                       dict(accel_level=RDO_SEQ_FB_LEVEL, rdo_fallback=True),
                       dict(maps=maps_l[0], chroma_maps=maps_c[0]))}
    for device in ("cpu", DEVICE):
        runs[f"{s}x{s} rdo on {device}"] = (device, (s, s), "satd", {}, dict(rdo=True))
        runs[f"{s}x{s} fallback L0 on {device}"] = (
            device, (s, s), "satd", dict(accel_level=0, rdo_fallback=True),
            dict(maps=small_l[0], chroma_maps=small_c[0]))
    result = {}
    with ProcessPoolExecutor(3, mp_context=multiprocessing.get_context("spawn"),
                             initializer=torch.set_num_threads, initargs=(2,)) as pool:
        futures = {label: pool.submit(seq_rdo_run, *run) for label, run in runs.items()}
        yield result
        out = {label: f.result() for label, f in futures.items()}
    streams, launches = {}, {}
    for label in ("rdo", "maps-rd-fb"):
        r = out[label]
        launches[label] = r["launches"]
        for name, n in r["launches"].items():
            check(n > 0, f"{label}: {name} was not launched in the RDO split search")
        check(r["searches"]["deferred"] > 0, f"{label}: no node reached the RDO split search")
        psnr = check_frame(f"[seq-rdo] {label}", r["bs"], r["recon"], r["frame"])
        stages = ", ".join(f"{k} {v:.3f}" for k, v in r["timings"].items())
        log(f"[seq-rdo] {label}: {w}x{h}, rdcheck's ctc_cfg, QP {RDO_SEQ_QP}, mode_select rd, "
            f"{len(RDO_SEQ_RMD)} RMD modes, in a worker process: host {r['wall']:.3f} s "
            f"({stages} s); launches {r['launches']}; deferred nodes "
            f"{r['searches']['deferred']} (won: {dict(r['searches']['won'])}), searches in "
            f"all {r['searches']['all']}; {8 * len(r['bs'])} bits, luma PSNR {psnr:.3f} dB, "
            f"hash SEI equal to the recon's MD5; {r['counts']}")
        log_call_mix(f"[seq-rdo] {label}:", r["mixes"])
        streams[f"rdo search, {label}"] = (r["bs"], [r["recon"]])
    for run in ("rdo", "fallback L0"):
        pair = {device: out[f"{s}x{s} {run} on {device}"] for device in ("cpu", DEVICE)}
        for device, r in pair.items():
            log(f"[seq-rdo-cpu-vs-card] {run}, {s}x{s}, on {device}: {r['wall']:.3f} s; "
                f"deferred nodes {r['searches']['deferred']}, searches in all "
                f"{r['searches']['all']}; {r['counts']}")
            check(r["searches"]["deferred"] > 0, f"{run}: no node reached the RDO split search")
        check(pair["cpu"]["bs"] == pair[DEVICE]["bs"],
              f"RDO split search ({run}): CPU and card bitstreams differ")
        log(f"[seq-rdo-cpu-vs-card] {run}: bitstreams byte-identical "
            f"({len(pair[DEVICE]['bs'])} bytes)")
        streams[f"rdo search {s}x{s}, {run}"] = (pair[DEVICE]["bs"], [pair[DEVICE]["recon"]])
    result.update(streams=streams, launches=launches)


def phase_seq_decode(streams: dict) -> dict:
    """The port's ``decode_stream(verify_hash=True)`` on the card on each of
    ``streams`` ({label: (stream, the encoder's recons)}): every hash
    verified and every recon equal to the encoder's. For each, the decode
    time per frame, K10a-c's launches (K10d must not launch) with their
    call mix (K10c's dequantise-and-inverse entries apart), and the coded
    tree's split decisions. K10a, K10b and K10c must launch, and K10c's
    mask DEQUANT | INV too. Returns the launches over all the decodes."""
    total = collections.Counter()
    fused = 0
    for label, (bs, recons) in streams.items():
        reset_seq_counts()
        with seq_call_mix(seq_enc, seq_dec) as mixes, parsed_splits() as splits:
            t0 = time.perf_counter()
            _, frames = seq_dec.decode_stream(bs, verify_hash=True, device=DEVICE)
            wall = time.perf_counter() - t0
        check(len(frames) == len(recons), f"decode {label}: {len(frames)} frames")
        for f, (got, want) in enumerate(zip(frames, recons)):
            check(all(np.array_equal(a, b) for a, b in zip(got, want)),
                  f"decode {label}: frame {f}'s recon differs from the encoder's")
        launches = k10_launches()
        check(launches["seq_satd"] == 0, f"decode {label}: K10d launched")
        total.update(launches)
        deq_inv = sum(n for key, n in mixes["k10c"].items()
                      if key[0] == quant_ops.DEQUANT | quant_ops.INV)
        fused += deq_inv
        log(f"[seq-decode] {label}: {len(frames)} frame(s), {len(bs)} bytes, "
            f"{1e3 * wall / len(frames):.3f} ms a frame on the card, every hash verified and "
            f"every recon the encoder's; launches {launches}, {deq_inv} of K10c's with the "
            f"mask DEQUANT | INV (a TU in one launch); coded splits "
            f"{dict(sorted(splits.items()))}")
        log_call_mix(f"[seq-decode] {label}:", {k: mixes[k] for k in ("k10a", "k10b", "k10c")})
    for name in ("seq_intra", "seq_mip", "seq_tq"):
        check(total[name] > 0, f"{name} was not launched by the decoder")
    check(fused > 0, "the decoder never launched K10c with DEQUANT | INV")
    log(f"[seq-decode] {len(streams)} streams: launches {dict(total)}")
    return dict(total)


# ---------------------------------------------------------------------------
# multi-device encoding: K12a (the CU-batch-sharded wave scan) and K12b (the
# spatial-stripe scan's halo pack and unpack, csrc/halo.cu)
# ---------------------------------------------------------------------------

MD_KERNELS = {  # name: (wrapper, source, the TPU kernel it replaces)
    "halo_pack": (sp.halo_pack, "pmp_vvc_tpu_torch/csrc/halo.cu",
                  "pmp_vvc_tpu/parallel/spatial.py:153"),
    "halo_unpack": (sp.halo_unpack, "pmp_vvc_tpu_torch/csrc/halo.cu",
                    "pmp_vvc_tpu/parallel/spatial.py:153"),
}
K12A_REPLACES = "pmp_vvc_tpu/codec/wavefront.py:656, pmp_vvc_tpu/parallel/wavefront_dp.py:33"
MD_FRAMES = 2
SPATIAL_W, SPATIAL_H = 512, 256          # the two-rank spatial encode
STRIPE_W, STRIPE_H = 256, 128            # the one-stripe encode
# the JAX package's spatial tool set (tests/test_spatial_sharding.py:22-26)
SPATIAL_TOOLS = dict(mts_intra=True, mip=True, cclm=True, lfnst=True, sign_hiding=True,
                     joint_cbcr=True, transform_skip=True, chroma_qp_start_minus26=-9,
                     chroma_qp_points=((9, 12), (4, 5), (11, 7)))
MD_TIMING_CALLS = 50
CHILD_TIMEOUT = 300                     # seconds for a two-rank child, start-up included


def spatial_cfg(w: int, h: int) -> VVCConfig:
    return VVCConfig(width=w, height=h, qp=32, **SPATIAL_TOOLS)


def bench_encoder(mesh=None) -> wf.WavefrontEncoder:
    """The bench's configuration exactly (``bench.py:186-197``: its tools,
    L3 with ``rdo_fallback``) at 416x240, on ``mesh`` or alone."""
    return wf.WavefrontEncoder(enc_cfg(SMALL_W, SMALL_H, BENCH), accel_level=3,
                               rdo_fallback=True, mesh=mesh, device=DEVICE)


def halo_planes(H: int, strd: int, seed: int, hl: int = sp.HL, hr: int = sp.HR) -> list:
    rng = np.random.RandomState(seed)
    we = hl + strd + hr
    return [torch.from_numpy(rng.randint(-(1 << 31), (1 << 31) - 1, s, dtype=np.int64)
                             .astype(np.int32)).to(DEVICE)
            for s in ((1, H, we), (1, H // 2, we // 2), (1, H // 2, we // 2))]


def halo_bounds(H: int, has_left: bool, has_right: bool) -> dict:
    """(bound ms, bytes) of K12b's pack (every band sample read once and
    written once) and unpack (the bands of the neighbours that exist)."""
    n_a, n_b = sp.band_size(H, sp.HL), sp.band_size(H, sp.HR)
    moved = {"halo_pack": n_a + n_b, "halo_unpack": n_a * has_left + n_b * has_right}
    return {k: (8 * n / HBM_BYTES_PER_S * 1e3, 8 * n) for k, n in moved.items()}


def halo_view_planes(H: int, strd: int, seed: int, hl: int = sp.HL, hr: int = sp.HR) -> list:
    """``halo_planes`` as views 4 bytes off the 16-byte grain."""
    out = []
    for p in halo_planes(H, strd, seed, hl, hr):
        flat = torch.empty(p.numel() + 1, dtype=torch.int32, device=DEVICE)
        out.append(flat[1:].view(p.shape).copy_(p))
    check(all(p.data_ptr() % 16 for p in out), "K12b's edge views are 16-byte aligned")
    return out


def halo_call(what: str, H: int, strd: int, has_left: bool, has_right: bool, seed: int,
              hl: int = sp.HL, hr: int = sp.HR, views: bool = False):
    """(the call, its plain outputs, the function that restores what it
    writes) of K12b's ``what`` ("pack" or "unpack") on seeded stripe planes
    of height H; the unpack's buffer is a neighbour's pack."""
    planes = (halo_view_planes if views else halo_planes)(H, strd, seed, hl, hr)
    if what == "pack":
        return ((lambda: [sp.halo_pack(planes, hl, hr, strd)]),
                [sp.halo_pack_reference(planes, hl, hr, strd)], lambda: None)
    buf = sp.halo_pack_reference([p.roll(1, -1) for p in planes], hl, hr, strd)
    initial = [p.clone() for p in planes]
    want = [p.clone() for p in planes]
    sp.halo_unpack_reference(buf, want, hl, hr, strd, has_left, has_right)

    def clear():
        for p, q in zip(planes, initial):
            p.copy_(q)

    def run():
        sp.halo_unpack(buf, planes, hl, hr, strd, has_left, has_right)
        return planes
    return run, want, clear


K12B_EDGE_CASES = ("strd 130: the scalar instantiation", "H 2",
                   "no neighbour: no launch", "left neighbour only", "right neighbour only",
                   "both neighbours", "hl 24, hr 96: quads by division",
                   "planes 4 bytes off the 16-byte grain: the scalar instantiation")
K12B_EDGE_SHAPES = (  # (H, strd, (has_left, has_right) pairs, hl, hr, views)
    (24, 130, ((True, True), (False, True), (True, False)), sp.HL, sp.HR, False),
    (2, 128, ((True, True), (False, False)), sp.HL, sp.HR, False),
    (64, 256, ((False, False), (True, False), (False, True), (True, True)), sp.HL, sp.HR,
     False),
    (24, 256, ((True, True), (False, True)), 24, 96, False),
    (24, 256, ((True, True), (True, False)), sp.HL, sp.HR, True))


def k12b_edge_calls() -> list:
    """``K12B_EDGE_CASES`` as (call, plain outputs) pairs; each unpack call
    restores its planes first, so that every build writes them anew."""
    calls = []
    for k, (H, strd, pairs, hl, hr, views) in enumerate(K12B_EDGE_SHAPES):
        run, want, _ = halo_call("pack", H, strd, True, True, 300 + k, hl, hr, views)
        calls.append((run, want))
        for j, (has_left, has_right) in enumerate(pairs):
            run, want, clear = halo_call("unpack", H, strd, has_left, has_right,
                                         310 + 10 * k + j, hl, hr, views)
            calls.append((lambda run=run, clear=clear: (clear(), run())[1], want))
    return calls


def k12b_edge_variant_checks() -> list:
    """``K12B_EDGE_CASES`` as one ``VARIANT_CHECKS`` entry."""
    def make():
        calls = k12b_edge_calls()
        return (lambda: [t for c, _ in calls for t in c()]), [t for _, w in calls for t in w]
    return [("K12B_EDGE_CASES", make)]


def phase_halo_kernels() -> tuple[dict, dict]:
    """K12b against its plain version on the card, exactly: seeded planes at
    every position of meshes of 1, 2 and 4 stripes (edge ranks, the
    interior ranks of four) at the two-rank spatial path's shapes (512x256
    over 2 stripes, over 4) and the one-stripe 256x128; unpack on the
    buffer a neighbour packed; then ``K12B_EDGE_CASES``. Then both kernels'
    device time per step (a CUDA graph of 50 calls) at the two-rank path's
    rank 0, the plain versions' and the byte bound."""
    errs = dict.fromkeys(MD_KERNELS, 0.0)
    cases = 0
    for H, W, D in ((SPATIAL_H, SPATIAL_W, 2), (SPATIAL_H, SPATIAL_W, 4),
                    (STRIPE_H, STRIPE_W, 1)):
        strd = W // D
        for me in range(D):
            planes = halo_planes(H, strd, seed=100 * D + me)
            buf = sp.halo_pack(planes, sp.HL, sp.HR, strd)
            _cmp("halo_pack", buf, sp.halo_pack_reference(planes, sp.HL, sp.HR, strd), errs)
            got = sp.halo_pack(halo_planes(H, strd, seed=7 + me), sp.HL, sp.HR, strd)
            ref = [p.clone() for p in planes]
            sp.halo_unpack(got, planes, sp.HL, sp.HR, strd, me > 0, me < D - 1)
            sp.halo_unpack_reference(got, ref, sp.HL, sp.HR, strd, me > 0, me < D - 1)
            _cmp("halo_unpack", planes, ref, errs)
            cases += 1
    for call, want in k12b_edge_calls():
        got = call()
        _cmp("halo_pack" if len(got) == 1 else "halo_unpack", got, want, errs)
    torch.cuda.synchronize()
    log(f"[multidevice-kernels] K12b pack and unpack equal to their plain versions on the card at "
        f"{cases} (mesh, rank) positions, edge and interior ranks, and on K12B_EDGE_CASES "
        f"{K12B_EDGE_CASES} (max_abs_err {errs})")

    H, strd = SPATIAL_H, SPATIAL_W // 2
    planes = halo_planes(H, strd, seed=1)
    buf = sp.halo_pack(planes, sp.HL, sp.HR, strd)
    bounds = halo_bounds(H, False, True)
    runs = {"halo_pack": (lambda: sp.halo_pack(planes, sp.HL, sp.HR, strd),
                          lambda: sp.halo_pack_reference(planes, sp.HL, sp.HR, strd)),
            "halo_unpack": (lambda: sp.halo_unpack(buf, planes, sp.HL, sp.HR, strd, False, True),
                            lambda: sp.halo_unpack_reference(buf, planes, sp.HL, sp.HR, strd,
                                                             False, True))}
    times = {}
    for name, (kernel, plain) in runs.items():
        ms, plain_ms = graph_ms(kernel), call_ms(plain, 20)
        bound, nbytes = bounds[name]
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes")
        log(f"[multidevice-kernels] {name} at {SPATIAL_W}x{SPATIAL_H} over 2 stripes, rank 0: device "
            f"time per step (CUDA graph of 50) {ms:.6f} ms; plain version from Python "
            f"{plain_ms:.6f} ms; bound {bound:.6f} ms by bytes ({nbytes} B)")
    return errs, times


def md_launches() -> dict:
    return {name: fn.launches for name, (fn, _, _) in {**ENC_KERNELS, **MD_KERNELS}.items()}


def reset_md_counts() -> None:
    reset_counts()
    for fn, _, _ in MD_KERNELS.values():
        fn.launches = 0
    comm.reset_stats()


def collective_ms(mesh, B: int = wf.DEFAULT_BATCH[32], P: int = 32) -> dict:
    """Host-clock time of one K12a all-gather of a luma class-step's packed
    buffer (``B`` rows of rec, lev and four codes at pad ``P``, this rank's
    share) and of one K12b neighbour exchange of the two-rank spatial path's
    halo buffer, each over MD_TIMING_CALLS calls ending in a synchronize
    (every rank runs the same calls)."""
    block = torch.zeros((B // mesh.size, 2 * P * P + 4), dtype=torch.int32, device=DEVICE)
    buf = torch.zeros((sp.band_size(SPATIAL_H, sp.HL) + sp.band_size(SPATIAL_H, sp.HR),),
                      dtype=torch.int32, device=DEVICE)
    split = sp.band_size(SPATIAL_H, sp.HL)
    runs = {"all_gather": lambda: comm.all_gather(mesh, block),
            "exchange": lambda: comm.neighbour_exchange(mesh, buf, split)}
    out = {}
    for name, fn in runs.items():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MD_TIMING_CALLS):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / MD_TIMING_CALLS * 1e3
    return out


def phase_md_nccl1(preds: dict, tmp: pathlib.Path) -> dict:
    """A one-rank NCCL group on the card: the bench's configuration at
    416x240 x 2 under the mesh, byte-identical to the meshless encode in the
    same call with equal K1-K7 launches; the one-stripe spatial encode at
    256x128 with the JAX package's spatial tools, equal to the meshless one;
    the collectives' times at world size 1 (NCCL's all-gather is a copy and
    the exchange has no neighbour). Tears the group down."""
    frames = natural_sequence(SMALL_W, SMALL_H, MD_FRAMES, seed0=7, bit_depth=BD)
    maps_l, maps_c = frame_maps(preds, frames, SMALL_W, SMALL_H)
    check(md.initialize(f"file://{tmp}/nccl1_store", 1, 0, device=DEVICE),
          "the one-rank NCCL group did not start")
    mesh = md.make_mesh(device=DEVICE)
    log(f"[multidevice-nccl1] group up: backend {mesh.backend}, transport {comm.transport(mesh)}, "
        f"world size {mesh.size}")
    out = {}
    for label, m in (("meshless", None), ("mesh", mesh)):
        enc = bench_encoder(m)
        enc.encode_frames(frames, maps=maps_l, chroma_maps=maps_c)      # cold
        reset_md_counts()
        t0 = time.perf_counter()
        outs = enc.encode_frames(frames, maps=maps_l, chroma_maps=maps_c)
        out[label] = dict(wall=time.perf_counter() - t0, streams=[o[0] for o in outs],
                          launches=md_launches(), gathers=list(comm.stats["all_gather"]))
        check_hashes(outs, frames, f"nccl1 {label}")
        log(f"[multidevice-nccl1] bench configuration at {SMALL_W}x{SMALL_H} x {MD_FRAMES}, {label}: "
            f"warm {out[label]['wall']:.3f} s, {enc.steps} wave steps, all-gathers "
            f"{out[label]['gathers'][0]} ({out[label]['gathers'][1]} B), launches "
            f"{out[label]['launches']}")
    check(out["mesh"]["streams"] == out["meshless"]["streams"],
          "the one-rank NCCL mesh stream differs from the meshless one")
    enc_names = list(ENC_KERNELS)
    check(all(out["mesh"]["launches"][k] == out["meshless"]["launches"][k] > 0
              for k in enc_names), "K1-K7 launches differ between mesh and meshless")
    check(out["mesh"]["gathers"][0] > 0, "the mesh encode ran no all-gather")

    y, u, v = natural_sequence(STRIPE_W, STRIPE_H, 1, seed0=11, bit_depth=BD)[0]
    cfg = spatial_cfg(STRIPE_W, STRIPE_H)
    want = wf.WavefrontEncoder(cfg, device=DEVICE).encode_frame(y, u, v)[0]
    reset_md_counts()
    got = spatial_encode(cfg, y, u, v, mesh)
    halo = md_launches()
    check(got == want, "the one-stripe spatial stream differs from the meshless one")
    check(halo["halo_pack"] > 0 and halo["halo_unpack"] == 0,
          f"K12b's launches on one stripe: {halo} (each step packs; with no neighbour the "
          f"unpack launches nothing)")
    times = collective_ms(mesh)
    log(f"[multidevice-nccl1] one-stripe spatial encode at {STRIPE_W}x{STRIPE_H}: {len(got)} bytes, "
        f"equal to the meshless stream; K12b launches {[halo[k] for k in MD_KERNELS]}; "
        f"NCCL at world size 1: all-gather of a 32-pad luma class-step "
        f"{times['all_gather']:.6f} ms, exchange (no neighbour) {times['exchange']:.6f} ms")
    md.shutdown()
    return dict(frames=frames, maps=(maps_l, maps_c), streams=out["meshless"]["streams"],
                launches=out["mesh"]["launches"], times=times)


def md_child(rank: int, tmp: pathlib.Path) -> int:
    """One of the two-rank phase's ranks (``chip_smoke.py --md-rank R DIR``):
    gloo on cuda:0 with host-staged tensors; the bench encode under the
    mesh, the spatial encode, the collectives' times; results pickled to
    DIR. Prints no result line."""
    job = pickle.loads((tmp / "job.pkl").read_bytes())
    md.initialize(f"file://{tmp}/store", 2, rank, backend="gloo", device=DEVICE)
    mesh = md.make_mesh(device=DEVICE)
    res = {"transport": comm.transport(mesh)}
    enc = bench_encoder(mesh)
    reset_md_counts()
    t0 = time.perf_counter()
    res["bench"] = [o[0] for o in enc.encode_frames(job["frames"], maps=job["maps"][0],
                                                     chroma_maps=job["maps"][1])]
    res["bench_wall"] = time.perf_counter() - t0
    res["bench_launches"], res["gathers"] = md_launches(), list(comm.stats["all_gather"])
    reset_md_counts()
    t0 = time.perf_counter()
    res["spatial"] = spatial_encode(spatial_cfg(SPATIAL_W, SPATIAL_H), *job["spatial"], mesh)
    res["spatial_wall"] = time.perf_counter() - t0
    res["spatial_launches"], res["exchanges"] = md_launches(), list(comm.stats["exchange"])
    res["times"] = collective_ms(mesh)
    (tmp / f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
    md.shutdown()
    return 0


def phase_md_2rank(nccl1: dict, tmp: pathlib.Path) -> dict:
    """Two spawned processes on cuda:0 under gloo (NCCL does not run two
    ranks on one GPU), tensors staged through host memory: the bench's
    configuration at 416x240 under the mesh, both ranks' streams equal to
    the single-process card stream; the spatial encode at 512x256 over two
    stripes with the JAX package's spatial tools, equal to the meshless card
    stream. A child that fails or outlives CHILD_TIMEOUT fails the phase;
    every child is killed before it returns."""
    y, u, v = natural_sequence(SPATIAL_W, SPATIAL_H, 1, seed0=13, bit_depth=BD)[0]
    want = wf.WavefrontEncoder(spatial_cfg(SPATIAL_W, SPATIAL_H), device=DEVICE).encode_frame(
        y, u, v)[0]
    (tmp / "job.pkl").write_bytes(pickle.dumps(
        {"frames": nccl1["frames"], "maps": nccl1["maps"], "spatial": (y, u, v)}))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--md-rank",
                               str(r), str(tmp)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=CHILD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"two-rank child {r} failed (exit {p.returncode}):\n"
              f"{out[-6000:]}")
    res = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes()) for r in range(2)]
    for r, x in enumerate(res):
        check(x["bench"] == nccl1["streams"],
              f"rank {r}'s bench stream differs from the single-process card stream")
        check(x["spatial"] == want, f"rank {r}'s spatial stream differs from the meshless one")
        check(all(x["bench_launches"][k] > 0 for k in ENC_KERNELS) and x["gathers"][0] > 0,
              f"rank {r}: the sharded encode did not launch every K1-K7 kernel")
        check(all(x["spatial_launches"][k] > 0 for k in MD_KERNELS),
              f"rank {r}: K12b was not launched on the spatial path")
        log(f"[multidevice-2rank] rank {r} ({x['transport']}): bench configuration at "
            f"{SMALL_W}x{SMALL_H} x {MD_FRAMES} under the mesh {x['bench_wall']:.3f} s (cold), "
            f"all-gathers {x['gathers'][0]} ({x['gathers'][1]} B sent), launches "
            f"{x['bench_launches']}; spatial {SPATIAL_W}x{SPATIAL_H} over 2 stripes "
            f"{x['spatial_wall']:.3f} s (cold), {len(x['spatial'])} bytes, exchanges "
            f"{x['exchanges'][0]} ({x['exchanges'][1]} B sent), K12b launches "
            f"{[x['spatial_launches'][k] for k in MD_KERNELS]}; all-gather of a 32-pad luma "
            f"class-step {x['times']['all_gather']:.6f} ms, halo exchange "
            f"{x['times']['exchange']:.6f} ms")
    log(f"[multidevice-2rank] both ranks' streams equal the single-process card streams; phase "
        f"{time.perf_counter() - t0:.3f} s")
    return res[0]


# ---------------------------------------------------------------------------
# the data-parallel CNN: K12c (the gradient bucket, csrc/grad_bucket.cu), the
# batch-sharded predictor, the data-parallel training step, entry and the
# dry run
# ---------------------------------------------------------------------------

DP_KERNELS = {  # name: (wrapper, source, the TPU kernel it replaces)
    "bucket_pack": (dp_ops.bucket_pack, "pmp_vvc_tpu_torch/csrc/grad_bucket.cu",
                    "pmp_vvc_tpu/train/trainer.py:63"),
}
DP_PATH_KERNELS = {"structural_vote": structural_vote, "qbd_loss": tg.qbd_loss,
                   "adam_update": tg.adam_update, "bucket_pack": dp_ops.bucket_pack}
DP_QP, DP_LR = 22, 2e-4                 # the luma QP 22 nets; the joint stage's lr
DP_STEPS, DP_2RANK_STEPS, DP_TIMED_STEPS = 5, 3, 10
# the CPU tests' bounds (tests/test_torch_train_step.py): the loss, and
# after the first step the parameters whose gradient clears DP_GRAD_MARGIN
# times the largest gradient difference. The gradient itself: cuDNN's
# backward algorithms for a batch of 16 and of 32 sum in other orders, and
# a sum's rounding scales with its terms, not with its result (a tensor
# whose terms cancel has a small one): the trained luma nets on float
# samples reach |g| ~ 58, and a draft run put the two-rank gradient 0.0124
# from the single-process one (two single-process runs with cuDNN's default
# algorithms: 0.0049), above the CPU tests' 1e-4 absolute. The bound:
# RAW_TOL, the card's bound for cuDNN's algorithms, of the largest |g|
DP_LOSS_RTOL, DP_GRAD_RTOL, DP_GRAD_MARGIN, DP_PARAM_ATOL = 1e-5, RAW_TOL, 10, 1e-7
# after the first step, a weight whose tiny gradient took the other sign
# has moved the other way by up to 2 lr, and the loss follows: 1.5e-5
# relative at step 2 in a draft run; two meshless runs with cuDNN's default
# (run-dependent) backward differ alike, and phase_dp_nccl1 logs by how much
DP_LATER_LOSS_RTOL = 1e-4
# raw predictor outputs of two batch cuts: cuDNN picks its convolution
# algorithms by shape, so a rank's block of 256 CTUs and the whole chunk of
# 512 sum in other orders (1.1e-4 apart on bt in a draft run, above the
# CPU tests' 1e-4): RAW_TOL, the card's bound for cuDNN's algorithms. A
# CTU's voted QT map must be equal where every pooled raw value keeps
# RAW_TOL from a rounding threshold, and nine CTUs in ten must keep it
DP_RAW_ATOL, DP_MARGIN, DP_MARGIN_SHARE = RAW_TOL, RAW_TOL, 0.9


def dp_blocks() -> np.ndarray:
    """The prediction path's luma CTUs: 1920x1080 x 2 frames (960 CTUs)."""
    frames = natural_sequence(W, H, FRAMES, seed0=7, bit_depth=8)
    y, u, v = (np.stack([f[i] for f in frames]).astype(np.uint8) for i in range(3))
    return blocks_for_sequence(y, u, v)[0]


def dp_predictor(mesh=None) -> CompPredictor:
    return CompPredictor.from_trained(True, CKPT / f"Luma_Q_QP{DP_QP}.msgpack",
                                      CKPT / f"Luma_BD_QP{DP_QP}.msgpack", device=DEVICE,
                                      mesh=mesh)


def dp_batches(n: int) -> list:
    """``n`` global luma batches of TRAIN_BATCH CTUs of seeded float samples
    and seeded labels (NCHW, on the host): float samples keep the nets away
    from the near-ties of 8-bit content (ROADMAP queue 3, PR 9)."""
    rng = np.random.RandomState(70)
    return [(rng.uniform(0, 255, (TRAIN_BATCH, 1, 68, 68)).astype(np.float32),
             rng.randint(0, 4, (TRAIN_BATCH, 1, 8, 8)).astype(np.float32),
             rng.randint(0, 4, (TRAIN_BATCH, 3, 16, 16)).astype(np.float32),
             rng.randint(-1, 2, (TRAIN_BATCH, 3, 16, 16)).astype(np.float32))
            for _ in range(n)]


def dp_train(batches, mesh=None, timed: int = 0) -> dict:
    """The joint luma QP 22 step from the committed checkpoints over
    ``batches`` (each rank on its ``shard_batch`` block under ``mesh``):
    each step's loss and the parameters after it (flat, on the host), the
    first step's reduced gradient (from Adam's first moment), then the warm
    steps/s of ``timed`` more steps on the last batch."""
    q_net, bd_net = LumaQNet().to(DEVICE), LumaMSBDNet().to(DEVICE)
    q_net.load_state_dict(params_from_jax(load_trained(CKPT / f"Luma_Q_QP{DP_QP}.msgpack")))
    bd_net.load_state_dict(params_from_jax(load_trained(CKPT / f"Luma_BD_QP{DP_QP}.msgpack")))
    opt = Adam(list(q_net.parameters()) + list(bd_net.parameters()))
    run = make_qbd_train_step(q_net, bd_net, opt, qp=DP_QP, is_luma=True, mesh=mesh)
    flat = lambda: torch.cat([p.detach().reshape(-1) for p in opt.params]).cpu().numpy()
    out = {"losses": [], "params": {}}
    for k, b in enumerate(batches):
        b = b if mesh is None else shard_batch(mesh, b)
        out["losses"].append(float(run(*(torch.from_numpy(a).to(DEVICE) for a in b), DP_LR)))
        if k == 0:
            out["grads"] = (opt.mu / float(tg.ADAM_CONSTS[1])).cpu().numpy()
        out["params"][k + 1] = flat()
    if timed:
        b = batches[-1] if mesh is None else shard_batch(mesh, batches[-1])
        args = [torch.from_numpy(a).to(DEVICE) for a in b]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            run(*args, DP_LR)
        torch.cuda.synchronize()
        out["steps_per_s"] = timed / (time.perf_counter() - t0)
    return out


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside, its default ones after: the
    default backward convolutions may sum in another order on every run, so
    two runs of one step differ in the last bits."""
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


def dp_predict(pred: CompPredictor, blocks: np.ndarray) -> tuple:
    """(maps, warm CTU predictions/s): a cold run, then a warm one timed on
    the host clock (``predict`` ends in the copies to the host)."""
    pred.predict(blocks)
    t0 = time.perf_counter()
    maps = pred.predict(blocks)
    return maps, len(blocks) / (time.perf_counter() - t0)


def adam_ratio_bound(t: int) -> float:
    """The largest |mu_hat| / sqrt(nu_hat) of optax's Adam at step ``t``
    (Cauchy-Schwarz over the gradients' weights): 1 at step 1, 1.0014 at 2."""
    b1, b2 = 0.9, 0.999
    s = sum(((1 - b1) * b1 ** (t - i)) ** 2 / ((1 - b2) * b2 ** (t - i))
            for i in range(1, t + 1))
    return float(np.sqrt(s) * np.sqrt(1 - b2 ** t) / (1 - b1 ** t))


def dp_hold_training(got: dict, want: dict, label: str) -> str:
    """Hold ``got``'s steps to ``want``'s within the CPU tests' bounds: the
    first step's loss within DP_LOSS_RTOL, the later ones' within
    DP_LATER_LOSS_RTOL; the first step's reduced gradient within
    DP_GRAD_RTOL of its largest magnitude; after it, the parameters whose
    gradient clears DP_GRAD_MARGIN times the largest difference within
    DP_PARAM_ATOL and the rest within 2 lr; after the last, within 2 lr
    times the sum of Adam's ratio bounds (a weight whose gradient sign
    differs may move the other way every step). Returns a summary."""
    n = len(got["losses"])
    rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"][:n])]
    check(rel[0] <= DP_LOSS_RTOL and max(rel) <= DP_LATER_LOSS_RTOL,
          f"{label}: losses off by {rel} relative")
    diff = float(np.abs(got["grads"] - want["grads"]).max())
    g_max = float(np.abs(want["grads"]).max())
    check(diff <= DP_GRAD_RTOL * g_max, f"{label}: the reduced gradient off by {diff} (the "
          f"largest |g| {g_max})")
    big = np.abs(want["grads"]) > DP_GRAD_MARGIN * diff
    p1, w1 = got["params"][1], want["params"][1]
    off = np.abs(p1 - w1)
    check(bool((off[big] <= DP_PARAM_ATOL + 1e-6 * np.abs(w1[big])).all()),
          f"{label}: step-1 parameters off by {float(off[big].max())} above the margin")
    check(float(off.max()) <= 2 * DP_LR * (1 + 1e-6), f"{label}: step-1 parameters off "
          f"by {float(off.max())}")
    bound = 2 * DP_LR * sum(adam_ratio_bound(t) for t in range(1, n + 1)) * (1 + 1e-6)
    last = float(np.abs(got["params"][n] - want["params"][n]).max())
    check(last <= bound, f"{label}: step-{n} parameters off by {last} (bound {bound})")
    return (f"losses within {rel[0]:.3g} relative at step 1 and {max(rel):.3g} after; "
            f"gradient within {diff:.3g} ({diff / g_max:.3g} of the largest |g|, {g_max:.4g}); "
            f"step-1 parameters within {float(off[big].max()):.3g} on the {int(big.sum())} "
            f"whose gradient clears the margin ({float(off.max()):.3g} on all); step-{n} "
            f"within {last:.3g} (bound {bound:.3g})")


def dp_hold_maps(got, want, qt_raw: np.ndarray, label: str) -> str:
    """Raw bt and dire within DP_RAW_ATOL; voted QT maps equal on every CTU
    whose pooled raw values (``qt_raw``, the reference's) keep DP_MARGIN
    from a rounding threshold, which nine CTUs in ten must."""
    errs = [float(np.abs(a - b).max()) for a, b in zip(got[1:], want[1:])]
    check(max(errs) <= DP_RAW_ATOL, f"{label}: raw bt / dire differ by {errs}")
    pooled = qt_raw.reshape(-1, 4, 2, 4, 2).max(axis=(2, 4))
    keep = (np.abs(pooled - np.floor(pooled) - 0.5) >= DP_MARGIN).all(axis=(1, 2))
    check(keep.mean() >= DP_MARGIN_SHARE, f"{label}: only {int(keep.sum())} of {len(keep)} "
          f"CTUs keep the margin")
    same = (got[0] == want[0]).all(axis=(1, 2))
    check(bool(same[keep].all()), f"{label}: voted QT maps differ away from a threshold")
    return (f"raw bt / dire within {max(errs):.3g}, voted QT equal on {int(same.sum())} of "
            f"{len(same)} CTUs ({int(keep.sum())} keep the margin)")


def all_reduce_ms(mesh, n: int, calls: int) -> float:
    """Host-clock time of one ``comm.all_reduce_sum`` of an ``n``-value
    bucket on the card, over ``calls`` calls ending in a synchronize (every
    rank runs the same calls)."""
    buf = torch.zeros(n, dtype=torch.float32, device=DEVICE)
    for _ in range(3):
        comm.all_reduce_sum(mesh, buf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        comm.all_reduce_sum(mesh, buf)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def reset_dp_counts() -> None:
    for fn in DP_PATH_KERNELS.values():
        fn.launches = 0
    comm.reset_stats()


def dp_counts() -> dict:
    return {name: fn.launches for name, fn in DP_PATH_KERNELS.items()}


def pair_grads(nets, seed: int) -> list:
    """Seeded gradients of the shapes of ``nets``' parameters on the card."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return [torch.randn(p.shape, generator=gen, device=DEVICE) * 10.0 ** (
                torch.rand(p.shape, generator=gen, device=DEVICE) * 8 - 7)
            for net in nets for p in net.parameters()]


def phase_dp_kernels() -> tuple[dict, dict]:
    """K12c against its plain version on the card, exactly: the luma and
    the chroma Q + BD pairs' gradient shapes at scales 1 and 1/2, and 300
    tensors (three launches); then its device time per call (a CUDA graph
    of 50) on the luma pair at scale 1/2, the plain version's and the byte
    bound."""
    errs = {"bucket_pack": 0.0}
    pairs = {"luma": (LumaQNet(), LumaMSBDNet()), "chroma": (ChromaQNet(), ChromaMSBDNet())}
    loss = torch.tensor(0.8125, device=DEVICE)
    cases = {name: pair_grads(nets, seed=k) for k, (name, nets) in enumerate(pairs.items())}
    cases["300 tensors"] = [g[:7].contiguous() for g in cases["chroma"] * 10][:300]
    for name, grads in cases.items():
        for scale in (1.0, 0.5):
            before = dp_ops.bucket_pack.launches
            got = dp_ops.bucket_pack(grads, loss, scale)
            want = dp_ops.bucket_pack_reference(grads, loss, scale)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            errs["bucket_pack"] = max(errs["bucket_pack"], err)
            check(torch.equal(got, want), f"K12c on the {name} shapes at scale {scale} differs "
                  f"from its plain version by {err}")
            check(dp_ops.bucket_pack.launches - before == -(-(len(grads) + 1) // 128),
                  f"K12c on {len(grads)} tensors: launches")
        log(f"[dp-kernels] K12c on the {name} gradient shapes ({len(grads)} tensors, "
            f"{sum(g.numel() for g in grads)} values and the loss) at scales 1 and 1/2: equal "
            f"to the plain version")
    times = {}
    for name in ("luma", "chroma"):
        grads = cases[name]
        n = sum(g.numel() for g in grads) + 1
        ms = graph_ms(lambda: dp_ops.bucket_pack(grads, loss, 0.5))
        plain_ms = call_ms(lambda: dp_ops.bucket_pack_reference(grads, loss, 0.5), 20)
        nbytes = 8 * n
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"[dp-kernels] K12c, the {name} pair ({len(grads)} tensors, {n} values): device "
            f"time per call (CUDA graph of 50) {ms:.6f} ms; plain version from Python "
            f"{plain_ms:.6f} ms; bound {bound:.6f} ms by bytes ({nbytes} B), "
            f"{100 * bound / ms:.1f}% of it")
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes")
    return errs, times["luma"]


def phase_dp_nccl1(tmp: pathlib.Path) -> dict:
    """A one-rank NCCL group on the card: the luma QP 22 predictor on the
    1080p x 2 CTUs under the mesh, bit-equal to the meshless one (the
    block is the whole chunk); DP_STEPS joint steps at batch 32 whose losses
    and parameters equal the meshless run's bit for bit; ``entry()`` and
    ``dryrun_multichip`` on the mesh; warm CTU predictions/s and steps/s
    beside the meshless ones; the all-reduce's time per step and K12c's
    launches. Tears the group down."""
    blocks = dp_blocks()
    batches = dp_batches(DP_STEPS)
    check(md.initialize(f"file://{tmp}/dp_nccl1_store", 1, 0, device=DEVICE),
          "the one-rank NCCL group did not start")
    mesh = md.make_mesh(device=DEVICE)
    out = {"blocks": blocks, "batches": batches}
    preds = {"meshless": dp_predictor(), "mesh": dp_predictor(mesh)}
    for label, pred in preds.items():
        reset_dp_counts()
        out[label], out[f"{label}_ctus_per_s"] = dp_predict(pred, blocks)
        log(f"[dp-nccl1] luma QP {DP_QP} predictor, {label}, {len(blocks)} CTUs (1920x1080 x "
            f"{FRAMES}), batch {BATCH}: {out[f'{label}_ctus_per_s']:.1f} warm CTU "
            f"predictions/s; launches {dp_counts()}, all-gathers "
            f"{comm.stats['all_gather']}")
    check(all(np.array_equal(a, b) for a, b in zip(out["mesh"], out["meshless"])),
          "the one-rank mesh predictor differs from the meshless one")
    with torch.inference_mode():
        x = torch.from_numpy(blocks).to(DEVICE).permute(0, 3, 1, 2).contiguous()
        out["qt_raw"] = np.concatenate([preds["meshless"].forward(x[i:i + BATCH])[0].cpu()
                                        .numpy() for i in range(0, len(x), BATCH)])

    for label, m in (("meshless", None), ("mesh", mesh)):
        reset_dp_counts()
        with cudnn_deterministic():
            out[f"train_{label}"] = dp_train(batches, m)
        launches, reduces = dp_counts(), list(comm.stats["all_reduce"])
        steps = dp_train(batches[-1:], m, timed=DP_TIMED_STEPS)["steps_per_s"]
        out[f"train_{label}"]["steps_per_s"] = steps
        log(f"[dp-nccl1] luma joint step, batch {TRAIN_BATCH}, {label}: {DP_STEPS} steps, "
            f"losses {out[f'train_{label}']['losses']}, launches {launches}, all-reduces "
            f"{reduces}; {steps:.2f} warm steps/s")
        if m is not None:
            out["launches"] = launches
    tm, tl = out["train_mesh"], out["train_meshless"]
    check(tm["losses"] == tl["losses"] and all(np.array_equal(tm["params"][k], tl["params"][k])
                                               for k in tl["params"]),
          "the one-rank mesh steps differ from the meshless ones")
    n = DP_2RANK_STEPS
    again = [dp_train(batches[:n]) for _ in range(2)]
    spread = float(np.abs(again[0]["params"][n] - again[1]["params"][n]).max())
    rel = max(abs(a - b) / abs(b) for a, b in zip(again[0]["losses"], again[1]["losses"]))
    g_spread = float(np.abs(again[0]["grads"] - again[1]["grads"]).max())
    log(f"[dp-nccl1] with cuDNN's deterministic algorithms the mesh and meshless steps are "
        f"bit-equal; with its default ones two meshless runs of {n} steps are "
        f"{'bit-equal' if spread == 0 else 'not bit-equal'}: first gradients up to "
        f"{g_spread:.3g} apart, parameters up to {spread:.3g}, losses up to {rel:.3g} "
        f"relative")
    check(out["launches"]["bucket_pack"] == DP_STEPS and out["launches"]["qbd_loss"] == DP_STEPS
          and out["launches"]["adam_update"] == DP_STEPS,
          f"the mesh steps' launches {out['launches']}")
    n_values = tl["params"][1].size + 1
    out["all_reduce_ms"] = all_reduce_ms(mesh, n_values, MD_TIMING_CALLS)
    log(f"[dp-nccl1] the one-rank mesh's losses and parameters equal the meshless run's bit "
        f"for bit; NCCL all-reduce of the {n_values}-value bucket at world size 1: "
        f"{out['all_reduce_ms']:.6f} ms a step")

    reset_dp_counts()
    fn, (x,) = entry()
    qt, bt, dire = fn(x)
    torch.cuda.synchronize()
    check(qt.shape == (8, 8, 8, 1) and bt.shape == dire.shape == (8, 16, 16, 3)
          and bool(torch.isfinite(bt).all() and torch.isfinite(dire).all())
          and bool(torch.isin(qt, torch.arange(4.0, device=DEVICE)).all())
          and structural_vote.launches == 1, "entry()")
    res = dryrun_multichip(mesh)
    check(np.isfinite(res["train"]) and len(res["wave"]) > 0 and res["spatial"] is None,
          f"dryrun_multichip on one rank: {res['train']}")
    log(f"[dp-nccl1] entry(): voted QT, bt and dire of the (8, 68, 68, 1) example through K8; "
        f"dryrun_multichip on one rank: loss {res['train']:.6f}, wave stream "
        f"{len(res['wave'])} bytes; launches {dp_counts()}")
    md.shutdown()
    return out


def dp_child(rank: int, tmp: pathlib.Path) -> int:
    """One of the two-rank data-parallel phase's ranks (``chip_smoke.py
    --dp-rank R DIR``): gloo on cuda:0 with host-staged tensors; the mesh
    predictor, DP_2RANK_STEPS joint steps, ``dryrun_multichip``, the
    all-reduce's time; results pickled to DIR. Prints no result line."""
    job = pickle.loads((tmp / "dp_job.pkl").read_bytes())
    md.initialize(f"file://{tmp}/dp_store", 2, rank, backend="gloo", device=DEVICE)
    mesh = md.make_mesh(device=DEVICE)
    res = {"transport": comm.transport(mesh)}
    reset_dp_counts()
    res["maps"], res["ctus_per_s"] = dp_predict(dp_predictor(mesh), job["blocks"])
    res["predict_launches"], res["gathers"] = dp_counts(), list(comm.stats["all_gather"])
    reset_dp_counts()
    with cudnn_deterministic():     # as the single-process run it is held to
        res["train"] = dp_train(job["batches"], mesh)
    res["train_launches"], res["reduces"] = dp_counts(), list(comm.stats["all_reduce"])
    res["train"]["steps_per_s"] = dp_train(job["batches"][-1:], mesh,
                                           timed=DP_TIMED_STEPS)["steps_per_s"]
    res["dryrun"] = dryrun_multichip(mesh)
    res["all_reduce_ms"] = all_reduce_ms(mesh, job["n_values"], 20)
    (tmp / f"dp_rank{rank}.pkl").write_bytes(pickle.dumps(res))
    md.shutdown()
    return 0


def phase_dp_2rank(nccl1: dict, tmp: pathlib.Path) -> dict:
    """Two spawned processes on cuda:0 under gloo (NCCL does not run two
    ranks on one GPU), tensors staged through host memory: the predictor on
    the 1080p x 2 CTUs within the raw and vote bounds of the single-process
    card run; DP_2RANK_STEPS joint steps whose parameters are bit-equal on
    the two ranks and within the CPU tests' bounds of the single-process
    card run; ``dryrun_multichip``; the all-reduce via host. A child that
    fails or outlives CHILD_TIMEOUT fails the phase."""
    want = nccl1["train_meshless"]
    n_values = want["params"][1].size + 1
    (tmp / "dp_job.pkl").write_bytes(pickle.dumps(
        {"blocks": nccl1["blocks"], "batches": nccl1["batches"][:DP_2RANK_STEPS],
         "n_values": n_values}))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--dp-rank",
                               str(r), str(tmp)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=CHILD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"two-rank data-parallel child {r} failed (exit "
              f"{p.returncode}):\n{out[-6000:]}")
    res = [pickle.loads((tmp / f"dp_rank{r}.pkl").read_bytes()) for r in range(2)]
    a, b = (x["train"] for x in res)
    check(a["losses"] == b["losses"] and all(np.array_equal(a["params"][k], b["params"][k])
                                             for k in a["params"]),
          "the two ranks' losses or parameters differ")
    check(all(np.array_equal(m, n) for m, n in zip(res[0]["maps"], res[1]["maps"])),
          "the two ranks' predictor maps differ")
    for r, x in enumerate(res):
        maps_txt = dp_hold_maps(x["maps"], nccl1["meshless"], nccl1["qt_raw"],
                                f"rank {r}'s predictor")
        train_txt = dp_hold_training(x["train"], want, f"rank {r}'s steps")
        dr = x["dryrun"]
        check(np.isfinite(dr["train"]) and len(dr["wave"]) > 0 and len(dr["spatial"]) > 0,
              f"rank {r}: dryrun_multichip")
        check(x["predict_launches"]["structural_vote"] > 0 and x["gathers"][0] > 0 and
              all(x["train_launches"][k] == DP_2RANK_STEPS
                  for k in ("qbd_loss", "adam_update", "bucket_pack")) and
              x["reduces"][0] == DP_2RANK_STEPS, f"rank {r}: launches {x['train_launches']}")
        log(f"[dp-2rank] rank {r} ({x['transport']}): predictor {maps_txt}; "
            f"{x['ctus_per_s']:.1f} warm CTU predictions/s a rank, all-gathers "
            f"{x['gathers']}; {DP_2RANK_STEPS} joint steps: {train_txt}; launches "
            f"{x['train_launches']}, all-reduces {x['reduces']}; {x['train']['steps_per_s']:.2f} "
            f"warm steps/s; dryrun_multichip loss {dr['train']:.6f}, wave {len(dr['wave'])} "
            f"bytes, spatial {len(dr['spatial'])} bytes; all-reduce of the {n_values}-value "
            f"bucket via host {x['all_reduce_ms']:.6f} ms")
    log(f"[dp-2rank] both ranks' parameters bit-equal after every step; phase "
        f"{time.perf_counter() - t0:.3f} s")
    return res[0]


# ---------------------------------------------------------------------------
# A redesigned kernel (K1-K7, K8, K9a-c, K10a-e, K11a, K12b) beside the
# parent commit's and its other shapes
# ---------------------------------------------------------------------------

def variant_library(kernel: str, src: pathlib.Path, out: pathlib.Path,
                    defines: tuple = (), signatures: dict = None) -> ctypes.CDLL:
    """``src`` (a source of ``kernel``'s library, ``TIMED_KERNELS``, beside
    its headers) built with the port's nvcc flags and ``defines`` into
    ``out`` and bound as its wrapper module binds it (or with
    ``signatures``); ptxas's registers, stack frame and spills are
    logged."""
    name, module = TIMED_KERNELS[kernel][:2]
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    check(proc.returncode == 0, f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    for line in ptxas_lines(proc.stdout + proc.stderr):
        log(f"[{kernel}-times] {out.name}: {line}")
    lib = ctypes.CDLL(str(out))
    for fn, args in (signatures or module.SIGNATURES[name]).items():
        getattr(lib, fn).argtypes = list(args)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def launching(kernel: str, lib):
    """``kernel``'s wrapper (``TIMED_KERNELS``) launching ``lib`` (None: the
    port's own build)."""
    name, module = TIMED_KERNELS[kernel][:2]
    saved = module._lib
    if lib is not None:
        module._lib = lambda n: lib if n == name else saved(n)
    try:
        yield
    finally:
        module._lib = saved


def rmd_inputs(P: int, scale: int, rows_np: np.ndarray, width: int, height: int):
    """K2's inputs on these rows, as ``phase_encode_kernel_times`` builds
    them: (refs, the luma original or None, the mode grid, rows)."""
    luma = scale == 1
    rec, org, og = kernel_planes(1, width, height, scale)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)  # noqa: E731
    rows = dev(rows_np)
    recs = [dev(r) for r in (rec, 1023 - rec)[:1 if luma else 2]]
    mg = torch.from_numpy(np.random.RandomState(2).randint(
        0, 67, (2, height // 4, width // 4)).astype(np.uint8)).to(DEVICE)
    return ref_gather(recs, dev(og), rows, P, scale, BD), dev(org) if luma else None, mg, rows


def k2_call(P: int, scale: int, rows_np: np.ndarray, width: int, height: int):
    """(K2's call on these rows, its plain version's outputs)."""
    refs, org0, mg, rows = rmd_inputs(P, scale, rows_np, width, height)
    args = (refs, org0, mg, rows, P, scale == 1, BD)
    return (lambda: intra_rmd(*args)), list(intra_rmd_reference(*args))


def k3_call(P: int, scale: int, rows_np: np.ndarray, width: int, height: int):
    """(K3's call on these luma rows after the port's K2, its plain
    version's outputs)."""
    refs, org0, mg, rows = rmd_inputs(P, 1, rows_np, width, height)
    modes, pred = intra_rmd(refs, org0, mg, rows, P, True, BD)
    args = (refs, org0, rows, pred, modes, P, BD)
    return (lambda: mip_select(*args)), list(mip_select_reference(*args))


def k5_call(P: int, tools: tuple, rows_np: np.ndarray, width: int, height: int):
    """(K5's call on these luma rows with ``tools`` (mts, lfnst, ts_max,
    sdh) after the port's K1, K2 and K3, as ``phase_encode_kernel_times``
    builds it, its plain version's outputs)."""
    refs, org0, mg, rows = rmd_inputs(P, 1, rows_np, width, height)
    modes, pred = intra_rmd(refs, org0, mg, rows, P, True, BD)
    best, pred, codes = mip_select(refs, org0, rows, pred, modes, P, BD)
    lam = 0.57 * 2 ** ((ENC_QP - 12) / 3)
    args = ([org0], pred, rows, P, ENC_QP + 12, BD, True, lam, best, codes, *tools)
    return (lambda: tq_mts(*args)), list(tq_mts_reference(*args))


def k5_rdo_call():
    """(K5 as the device RDO calls it on one 16,384-rect chunk of the 8-pad
    class (``phase_rdo_kernels``: the luma tree's 4x4 to 8x8 rects of a
    1080p frame, K9a's winners, QP 22's point, DCT-2 and MTS), its plain
    version's outputs)."""
    rows_np = rdo_chunk_rows(np.random.RandomState(5), trd._BATCH_CUDA[8], False)
    frame = natural_frame(ENC_W, ENC_H, 7, bit_depth=BD)
    oy, ou, ov = (torch.from_numpy(p[None].astype(np.int32)).to(DEVICE) for p in frame)
    rows = torch.from_numpy(rows_np).to(DEVICE)
    og0 = rg._zero_grid(oy)
    refs = ref_gather([oy], og0, rows, 8, 1, BD)
    crefs = ref_gather([ou, ov], og0, rows, 4, 2, BD)
    modes, pred, _ = rg.rdo_luma_select(refs, crefs, oy, rows, 8, BD)
    qp_y, _, lam, _ = rdo_qp_points(ENC_W, ENC_H, (ENC_QP,))[0]
    args = ([oy], pred, rows, 8, qp_y, BD, True, lam, modes)
    return (lambda: tq_mts(*args, mts=True)), list(tq_mts_reference(*args, mts=True))


def probe_rows(width: int, height: int, side: int) -> np.ndarray:
    """16 32-pad CUs of side x side, each at its cell's top-left: with the
    timed classes, what splits a call's time into what every call costs and
    what grows with the CUs."""
    rows_np = kernel_rows(32, 1, seed=1, width=width, height=height)[:16]
    rows_np[:, 1:3] -= rows_np[:, 1:3] % 32
    rows_np[:, 3:5] = side
    return rows_np


def class_cases(make_call, classes):
    """``phase_variant_times``' cases of K2 / K3: the timed classes at
    their batches, then the two probes (16 CUs of 4x4, of 32x32)."""
    def cases(width: int, height: int) -> list:
        out = [(f"{P}-pad {'luma' if scale == 1 else 'chroma'}, {B} CUs",
                functools.partial(make_call, P, scale,
                                  kernel_rows(P, scale, seed=1, width=width,
                                              height=height)[:B], width, height))
               for P, scale, B in classes]
        return out + [(f"32-pad luma, 16 CUs of {side}x{side}",
                       functools.partial(make_call, 32, 1, probe_rows(width, height, side),
                                         width, height)) for side in (4, 32)]
    return cases


def k5_cases(width: int, height: int) -> list:
    """``phase_variant_times``' cases of K5: the luma classes with the main
    path's tools, the 32-pad class with the tools off (SDH on), the RDO's
    8-pad chunk with MTS, and the two probes with every tool."""
    tools = {32: (True, True, 32, True), 64: (False, True, 0, True)}
    out = [(f"{P}-pad luma, {B} CUs",
            functools.partial(k5_call, P, tools[P],
                              kernel_rows(P, 1, seed=1, width=width, height=height)[:B],
                              width, height))
           for P, scale, B in TIMED_CLASSES if scale == 1]
    out.append(("32-pad luma, 16 CUs, tools off",
                functools.partial(k5_call, 32, (False, False, 0, True),
                                  kernel_rows(32, 1, seed=1, width=width, height=height)[:16],
                                  width, height)))
    out.append((f"8-pad luma, {trd._BATCH_CUDA[8]:,} RDO rects, MTS", k5_rdo_call))
    return out + [(f"32-pad luma, 16 CUs of {side}x{side}",
                   functools.partial(k5_call, 32, tools[32], probe_rows(width, height, side),
                                     width, height)) for side in (4, 32)]


def k6a_call(P: int, rows_np: np.ndarray, width: int, height: int):
    """(K6a's call on these chroma rows, the CCLM gate set, after the port's
    K1 and K2's DM prediction, as ``phase_encode_kernel_times`` builds it,
    its plain version's outputs)."""
    rows_np = rows_np.copy()
    rows_np[:, 7] = 1
    refs, _, mg, rows = rmd_inputs(P, 2, rows_np, width, height)
    _, pred = intra_rmd(refs, None, mg, rows, P, False, BD)
    rec, org, og = kernel_planes(1, width, height, 2)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)  # noqa: E731
    args = (refs, dev(cclm_luma(rec, 1)), [dev(org), dev(1023 - org)], dev(og), rows, pred, P,
            BD)
    return (lambda: cclm_select(*args)), list(cclm_select_reference(*args))


def k6a_rdo_call():
    """(K6a as the device RDO's chroma tree calls it on one 16,384-rect chunk
    of the 4-pad chroma class (``phase_rdo_kernels``: 8x8 luma rects of a
    1080p frame, K9b's choice, the luma original for the recon, a zero order
    grid), its plain version's outputs)."""
    rows_np = rdo_chunk_rows(np.random.RandomState(5), trd._BATCH_CUDA[8], True)
    frame = natural_frame(ENC_W, ENC_H, 7, bit_depth=BD)
    oy, ou, ov = (torch.from_numpy(p[None].astype(np.int32)).to(DEVICE) for p in frame)
    rows = torch.from_numpy(rows_np).to(DEVICE)
    og0 = rg._zero_grid(oy)
    crefs = ref_gather([ou, ov], og0, rows, 4, 2, BD)
    cpred, _ = rg.rdo_chroma_select(crefs, [ou, ov], rows, 4, BD)
    args = (crefs, oy, [ou, ov], og0, rows, cpred, 4, BD)
    return (lambda: cclm_select(*args)), list(cclm_select_reference(*args))


def chroma_probe_rows(width: int, height: int, side: int) -> np.ndarray:
    """16 CUs of the 32-pad chroma class of side x side luma samples, each at
    the top-left of its own 64x64 luma cell of two frames."""
    nx, per = width // 64, (width // 64) * (height // 64)
    rows = []
    for c in range(16):
        fi, cell = divmod(c, per)
        cy, cx = divmod(cell, nx)
        rows.append((fi, cx * 64, cy * 64, side, side, 100 + c, 1, 1))
    return np.array(rows, np.int32)


def k6a_cases(width: int, height: int) -> list:
    """``phase_variant_times``' cases of K6a: the two chroma classes at
    their batches, the RDO's 4-pad chunk, and two probes of the 32-pad
    class (16 CUs of 2x2, of 32x32 chroma samples)."""
    out = [(f"{P}-pad chroma, {B} CUs",
            functools.partial(k6a_call, P, kernel_rows(P, 2, seed=1, width=width,
                                                       height=height)[:B], width, height))
           for P, scale, B in TIMED_CLASSES if scale == 2]
    out.append((f"4-pad chroma, {trd._BATCH_CUDA[8]:,} RDO rects", k6a_rdo_call))
    return out + [(f"32-pad chroma, 16 CUs of {side // 2}x{side // 2}",
                   functools.partial(k6a_call, 32, chroma_probe_rows(width, height, side),
                                     width, height)) for side in (4, 64)]


def k4_call(P: int, rows_np: np.ndarray, width: int, height: int, crs: bool = True,
            jccr: bool = True):
    """(K4's call on these chroma rows, the CCLM gate set, after the port's
    K1, K2's DM prediction and K6a, as ``phase_encode_kernel_times`` builds
    it: sign-data hiding, with ``jccr`` the joint trial at the chroma QP, with
    ``crs`` the chroma residual scale; its plain version's outputs)."""
    rows_np = rows_np.copy()
    rows_np[:, 7] = 1
    refs, _, mg, rows = rmd_inputs(P, 2, rows_np, width, height)
    _, pred = intra_rmd(refs, None, mg, rows, P, False, BD)
    rec, org, og = kernel_planes(1, width, height, 2)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)  # noqa: E731
    ry, og_t, orgs = dev(cclm_luma(rec, 1)), dev(og), [dev(org), dev(1023 - org)]
    pred, _ = cclm_select(refs, ry, orgs, og_t, rows, pred, P, BD)
    qp_c, lam = ENC_QP + 12, 0.57 * 2 ** ((ENC_QP - 12) / 3)
    args = (orgs, pred, rows, P, 2, qp_c, BD, True, lam, 1.2599, True, None, jccr, qp_c)
    if not crs:
        return (lambda: tq(*args)), list(tq_reference(*args))
    src = (ry, og_t, device_crs_lut())
    want = tq_reference(*args, crs=crs_scale_reference(*src[:2], rows, src[2], BD))
    return (lambda: tq(*args, crs_src=src)), list(want)


def k4_rdo_call():
    """(K4 as the device RDO's luma tree calls it on one 16,384-rect chunk of
    the 4-pad chroma class (``phase_rdo_kernels``: 4x4 to 8x8 luma rects of a
    1080p frame, K9a's chroma predictions, QP 22's point; U and V, no trial,
    no sign-data hiding, no scale), its plain version's outputs)."""
    rows_np = rdo_chunk_rows(np.random.RandomState(5), trd._BATCH_CUDA[8], False)
    frame = natural_frame(ENC_W, ENC_H, 7, bit_depth=BD)
    oy, ou, ov = (torch.from_numpy(p[None].astype(np.int32)).to(DEVICE) for p in frame)
    rows = torch.from_numpy(rows_np).to(DEVICE)
    og0 = rg._zero_grid(oy)
    refs = ref_gather([oy], og0, rows, 8, 1, BD)
    crefs = ref_gather([ou, ov], og0, rows, 4, 2, BD)
    _, _, cpred = rg.rdo_luma_select(refs, crefs, oy, rows, 8, BD)
    _, qp_c, lam, dw = rdo_qp_points(ENC_W, ENC_H, (ENC_QP,))[0]
    args = ([ou, ov], cpred, rows, 4, 2, qp_c, BD, True, lam, dw)
    return (lambda: tq(*args)), list(tq_reference(*args))


def k4_cases(width: int, height: int) -> list:
    """``phase_variant_times``' cases of K4: the two chroma classes at their
    batches with the main path's tools (the trial, SDH, the chroma residual
    scale) and without the scale, the 16-pad class without the trial, the
    RDO's 4-pad chunk, and two probes of the 32-pad class (16 CUs of 2x2 and
    of 32x32 chroma samples) with the main path's tools."""
    classes = [(P, B, kernel_rows(P, 2, seed=1, width=width, height=height)[:B])
               for P, scale, B in TIMED_CLASSES if scale == 2]
    out = [(f"{P}-pad chroma, {B} CUs" + ("" if crs else ", CRS off"),
            functools.partial(k4_call, P, rows, width, height, crs))
           for crs in (True, False) for P, B, rows in classes]
    P, B, rows = classes[0]
    out.append((f"{P}-pad chroma, {B} CUs, no trial, no CRS",
                functools.partial(k4_call, P, rows, width, height, False, False)))
    out.append((f"4-pad chroma, {trd._BATCH_CUDA[8]:,} RDO rects", k4_rdo_call))
    return out + [(f"32-pad chroma, 16 CUs of {side // 2}x{side // 2}",
                   functools.partial(k4_call, 32, chroma_probe_rows(width, height, side),
                                     width, height)) for side in (4, 64)]


def k1_call(P: int, scale: int, rows_np: np.ndarray, width: int, height: int):
    """(K1's call on these rows and ``kernel_planes``' recon and order grid,
    as ``phase_encode_kernel_times`` builds it, its plain version's outputs)."""
    rec, _, og = kernel_planes(1, width, height, scale)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)  # noqa: E731
    args = ([dev(r) for r in (rec, 1023 - rec)[:1 if scale == 1 else 2]], dev(og),
            dev(rows_np), P, scale, BD)
    return (lambda: ref_gather(*args)), list(ref_gather_reference(*args))


def k1_rdo_call(chroma: bool):
    """(K1 as the device RDO's luma tree calls it on one 16,384-rect chunk of
    1080p rects (``ops/rdo_generic.py:294-295``): the 8-pad luma class, or
    the 4-pad chroma class on U and V; the open loop's zero order grid), its
    plain version's outputs."""
    rows_np = rdo_chunk_rows(np.random.RandomState(5), trd._BATCH_CUDA[8], False)
    frame = natural_frame(ENC_W, ENC_H, 7, bit_depth=BD)
    oy, ou, ov = (torch.from_numpy(p[None].astype(np.int32)).to(DEVICE) for p in frame)
    rows = torch.from_numpy(rows_np).to(DEVICE)
    og0 = rg._zero_grid(oy)
    args = ([ou, ov], og0, rows, 4, 2, BD) if chroma else ([oy], og0, rows, 8, 1, BD)
    return (lambda: ref_gather(*args)), list(ref_gather_reference(*args))


def k1_cases(width: int, height: int) -> list:
    """``phase_variant_times``' cases of K1: the timed classes, the two
    probes, and the RDO's 8-pad luma and 4-pad chroma chunks."""
    B = trd._BATCH_CUDA[8]
    return class_cases(k1_call, TIMED_CLASSES)(width, height) + [
        (f"8-pad luma, {B:,} RDO rects", functools.partial(k1_rdo_call, False)),
        (f"4-pad chroma, {B:,} RDO rects, two planes", functools.partial(k1_rdo_call, True))]


def k7_call(P: int, scale: int, rows_np: np.ndarray, width: int, height: int):
    """(K7's call on these rows with random recon and level tiles and the
    main path's grids (four for luma, the CCLM / joint grid for chroma),
    returning the planes and grids it writes; their state after the plain
    version; a function that zeroes them, so that each checked call writes
    them anew)."""
    luma = scale == 1
    n, B = 1 if luma else 2, len(rows_np)
    rng = np.random.RandomState(P + scale)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)  # noqa: E731
    rows = dev(rows_np)
    rec = dev(rng.randint(0, 1024, (n, B, P, P)).astype(np.int32))
    lev = dev(rng.randint(-600, 601, (n, B, P, P)).astype(np.int32))
    shape = (2, height // scale, width // scale)
    planes = [(torch.zeros(shape, dtype=torch.int32, device=DEVICE),
               torch.zeros(shape, dtype=torch.int16, device=DEVICE)) for _ in range(n)]
    grids = [(torch.zeros((2, height // 4, width // 4), dtype=torch.uint8, device=DEVICE),
              dev(rng.randint(0, 67, B).astype(np.int32))) for _ in range(4 if luma else 1)]
    ref_planes = [(a.clone(), b.clone()) for a, b in planes]
    ref_grids = [(g.clone(), c) for g, c in grids]
    wf.wave_scatter_reference(rows, P, scale, ref_planes, rec, lev, ref_grids)
    state = lambda ps, gs: [t for p in ps for t in p] + [g for g, _ in gs]  # noqa: E731

    def call():
        wf.wave_scatter(rows, P, scale, planes, rec, lev, grids)
        return state(planes, grids)

    def reset():
        for t in state(planes, grids):
            t.zero_()
    return call, state(ref_planes, ref_grids), reset


def rdo_probe_rows(side: int) -> np.ndarray:
    """(16, 8) int32 rows of side x side rects (luma units) at random
    4-aligned places of a 1080p frame."""
    rng = np.random.RandomState(6)
    rows_np = np.zeros((16, 8), np.int32)
    rows_np[:, 1] = rng.randint(0, (ENC_W - side) // 4, 16) * 4
    rows_np[:, 2] = rng.randint(0, (ENC_H - side) // 4, 16) * 4
    rows_np[:, 3:5] = side
    rows_np[:, 5:] = 1
    return rows_np


def k9a_probe_call(side: int):
    """(K9a on 16 rects of side x side at random 4-aligned places of a 1080p
    frame, in the 8-pad class up to 8x8, else the side's; its plain
    version's outputs)."""
    frame = natural_frame(ENC_W, ENC_H, 7, bit_depth=BD)
    return k9a_call(max(side, 8), rdo_probe_rows(side),
                    [p[None].astype(np.int32) for p in frame])


def k9a_cases(width: int, height: int) -> list:
    """``phase_variant_times``' cases of K9a: one full chunk of each pad
    class as the device RDO calls it on 1080p rects (``_BATCH_CUDA``), then
    two probes (16 rects of 4x4, of 32x32); ``width`` and ``height`` unused."""
    return [(f"{P}-pad luma, {trd._BATCH_CUDA[P]:,} RDO rects", functools.partial(k9a_rdo_call, P))
            for P in (8, 16, 32, 64)] + [
        (f"{max(side, 8)}-pad luma, 16 rects of {side}x{side}",
         functools.partial(k9a_probe_call, side)) for side in (4, 32)]


def k9a_tie_cases() -> list:
    """K9a's tie and edge inputs of every pad class (``K9A_TIES``), on
    which ``phase_variant_times`` holds each variant to the plain version."""
    return [(f"{P}-pad tie cases",
             functools.partial(lambda P: k9a_call(P, *k9a_tie_inputs(P, P)[:2]), P))
            for P in K9A_TIES]


def k9b_probe_call(side: int):
    """(K9b on 16 rects of side x side chroma samples at random places of a
    1080p frame, in the class of their luma side; its plain version's
    outputs)."""
    frame = natural_frame(ENC_W, ENC_H, 7, bit_depth=BD)
    return k9b_call(2 * side, rdo_probe_rows(2 * side), [p[None].astype(np.int32) for p in frame])


def k9b_cases(width: int, height: int) -> list:
    """``phase_variant_times``' cases of K9b: one full chunk of each pad
    class's chroma tree as the device RDO calls it on 1080p rects
    (``_BATCH_CUDA``), then two probes (16 rects of 4x4 and of 32x32 chroma
    samples); ``width`` and ``height`` unused."""
    return [(f"{P}-pad chroma tree, {trd._BATCH_CUDA[P]:,} RDO rects",
             functools.partial(k9b_rdo_call, P)) for P in (8, 16, 32, 64)] + [
        (f"{2 * side}-pad, 16 rects of {side}x{side} chroma samples",
         functools.partial(k9b_probe_call, side)) for side in (4, 32)]


def k9b_tie_cases() -> list:
    """K9b's tie and edge inputs of every pad class (``K9B_TIES``), on
    which ``phase_variant_times`` holds each variant to the plain version."""
    return [(f"{P}-pad tie cases",
             functools.partial(lambda P: k9b_call(P, *k9b_tie_inputs(P, P)[:2]), P))
            for P in K9B_TIES]


def k9c_cases(width: int, height: int) -> list:
    """``phase_variant_times``' cases of K9c: one full chunk of each pad
    class (``_BATCH_CUDA``) of 1080p rects in the luma and in the chroma
    tree, at 1 QP point (the L0 path) and at 4 (the label search);
    ``width`` and ``height`` unused."""
    return [(f"{P}-pad {'chroma' if chroma else 'luma'} tree, {trd._BATCH_CUDA[P]:,} RDO "
             f"rects, {nqp} QP point(s)", functools.partial(k9c_rdo_call, P, chroma, nqp))
            for P in (8, 16, 32, 64) for chroma in (False, True) for nqp in (1, 4)]


def k9c_edge_cases() -> list:
    """K9c's edge calls of every pad class (``k9c_edge_calls``), on which
    ``phase_variant_times`` holds each variant to the plain version."""
    return [(label, functools.partial(k9c_call, args))
            for P in (8, 16, 32, 64) for label, args in k9c_edge_calls(P)]


def k10c_call(stages: int, w: int, h: int, n: int = 1, qp: int = 37):
    """(K10c on n random DCT-2 TUs of w x h through ``stages``, its plain
    version's outputs)."""
    x = seq_tq_input(stages, w, h, n, np.random.RandomState(w * 131 + h * 7 + stages))
    kw = dict(kind_h=DCT2, kind_v=DCT2, qp=qp, bit_depth=BD)
    return (lambda: quant_ops.seq_tq(x, stages, **kw)), list(quant_ops.seq_tq_reference(x, stages,
                                                                                          **kw))


def k10c_cases(width: int, height: int) -> list:
    """``phase_variant_times``' cases of K10c: the 16x16 fused round trip at
    QP 37, the sequential path's most launched shapes (the forward and the
    inverse transform alone at 32x16, 32x32 and 16x16: with dependent
    quantisation on, its TUs take the host trellis between the two), a
    64x64 round trip, an ISP 1x16 round trip and 16 TUs of 8x8 in one
    call; ``width`` and ``height`` unused."""
    FWD, INV, RT = quant_ops.FWD, quant_ops.INV, quant_ops.ROUND_TRIP
    cases = [("16x16 round trip, QP 37", RT, 16, 16, 1)]
    cases += [(f"{'forward' if st == FWD else 'inverse'} transform alone, {w}x{h}", st, w, h, 1)
              for w, h in ((32, 16), (32, 32), (16, 16)) for st in (FWD, INV)]
    cases += [("64x64 round trip", RT, 64, 64, 1), ("1x16 (ISP) round trip", RT, 1, 16, 1),
              ("16 TUs of 8x8, round trip", RT, 8, 8, 16)]
    return [(label, functools.partial(k10c_call, st, w, h, n)) for label, st, w, h, n in cases]


def k10d_call(w: int, h: int, k: int, per_candidate: bool = False):
    """(K10d on k random candidates of w x h against one original or one
    each, its plain version's outputs)."""
    rng = np.random.RandomState(w * 131 + h + k)
    org = torch.from_numpy(rng.randint(0, 1024, (k if per_candidate else 1, h, w))
                           .astype(np.int32)).to(DEVICE)
    cur = torch.from_numpy(rng.randint(0, 1024, (k, h, w)).astype(np.int32)).to(DEVICE)
    return (lambda: [dist_ops.satd(org, cur)]), [dist_ops.satd_reference(org, cur)]


def k10d_cases(width: int, height: int) -> list:
    """``phase_variant_times``' cases of K10d: 67 candidates at 16x16 (RMD's
    count), at 32x16 (8x16 tiles; the sequential path's most launched
    shape), 32x32 and 64x64, 12 at 32x16 (MIP's), a 4x4 block, a 2x8
    chroma block (2x2 tiles) and 8 chroma candidates at 16x16 each against
    its own original; ``width`` and ``height`` unused."""
    cases = [(16, 16, 67, False), (32, 16, 67, False), (32, 32, 67, False), (64, 64, 67, False),
             (32, 16, 12, False), (4, 4, 67, False), (2, 8, 8, False), (16, 16, 8, True)]
    return [(f"{k} candidates of {w}x{h}" + (", an original each" if per else ""),
             functools.partial(k10d_call, w, h, k, per)) for w, h, k, per in cases]


def k10c_edge_variant_checks() -> list:
    """K10c's edge cases (``k10c_edge_inputs``) as one ``VARIANT_CHECKS``
    entry."""
    def make():
        calls = [(torch.from_numpy(x).to(DEVICE), st, dict(kind_h=kh, kind_v=kv, qp=qp,
                                                            bit_depth=bd))
                 for _, x, st, kh, kv, qp, bd in k10c_edge_inputs()]
        return ((lambda: [quant_ops.seq_tq(x, st, **kw) for x, st, kw in calls]),
                [quant_ops.seq_tq_reference(x, st, **kw) for x, st, kw in calls])
    return [("K10C_EDGE_CASES", make)]


def k10d_edge_variant_checks() -> list:
    """K10d's edge cases (``k10d_edge_inputs``) as one ``VARIANT_CHECKS``
    entry."""
    def make():
        pairs = [tuple(torch.from_numpy(a).to(DEVICE) for a in p) for p in k10d_edge_inputs()]
        return ((lambda: [dist_ops.satd(o, c) for o, c in pairs]),
                [dist_ops.satd_reference(o, c) for o, c in pairs])
    return [("K10D_EDGE_CASES", make)]


def k10a_call(w: int, h: int, modes: tuple, luma: bool, n: int = 1):
    """(K10a on n CUs of w x h for ``modes``, its plain version's outputs),
    the rows uploaded as the encoder uploads them."""
    rng = np.random.RandomState(w * 131 + h * 7 + len(modes) + n)
    refs = dev_views(k10a_rows("random", n, w, h, BD, luma, rng))
    kw = dict(w=w, h=h, modes=modes, is_luma=luma, bit_depth=BD)
    return ((lambda: [intra_ops.predict_block(*refs, **kw)]),
            [intra_ops.predict_block_reference(*refs, **kw)])


def k10a_cases(width: int, height: int) -> list:
    """``phase_variant_times``' cases of K10a: the 67 RMD modes at 4x4,
    16x16, 32x32 and 64x64 luma, a chroma CU's U and V in one call (its
    DM and the four others) at 4x4 and 16x16, planar alone at 16x16 luma
    (``mode_select="planar"``); ``width`` and ``height`` unused."""
    cases = [(f"67 modes, {s}x{s} luma", s, s, ALL_MODES, True, 1) for s in (4, 16, 32, 64)]
    cases += [(f"U and V, {s}x{s} chroma, 5 modes", s, s, CHROMA_MODES, False, 2)
              for s in (4, 16)]
    cases += [("planar alone, 16x16 luma", 16, 16, (0,), True, 1)]
    return [(label, functools.partial(k10a_call, w, h, modes, luma, n))
            for label, w, h, modes, luma, n in cases]


def k10b_call(w: int, h: int):
    """(K10b on one w x h block, its plain version's outputs), the rows
    uploaded as the encoder uploads them."""
    rng = np.random.RandomState(w * 131 + h)
    top, left = dev_views([r[0] for r in k10a_rows("random", 1, w, h, BD, False, rng)[:2]])
    kw = dict(w=w, h=h, bit_depth=BD)
    return ((lambda: [mip_ops.predict_mip_all(top, left, **kw)]),
            [mip_ops.predict_mip_all_reference(top, left, **kw)])


def k10b_cases(width: int, height: int) -> list:
    """``phase_variant_times``' cases of K10b: every size class (4x4,
    8x8, 16x16), both 16-fold upsamplings' shape 4x64 and 64x64;
    ``width`` and ``height`` unused."""
    return [(f"{w}x{h}, {2 * mip_ops.num_modes(w, h)} candidates",
             functools.partial(k10b_call, w, h))
            for w, h in ((4, 4), (8, 8), (16, 16), (4, 64), (64, 64))]


def k10a_edge_variant_checks() -> list:
    """K10a's edge cases (``k10a_edge_inputs``) as one ``VARIANT_CHECKS``
    entry."""
    def make():
        calls = k10a_edge_calls()
        return (lambda: [call() for call, _ in calls]), [want for _, want in calls]
    return [("K10A_EDGE_CASES", make)]


def k10b_edge_variant_checks() -> list:
    """K10b's edge cases (``k10b_edge_inputs``) as one ``VARIANT_CHECKS``
    entry."""
    def make():
        calls = k10b_edge_calls()
        return (lambda: [call() for call, _ in calls]), [want for _, want in calls]
    return [("K10B_EDGE_CASES", make)]


LAUNCH_FLOOR_SRC = _build.CSRC / "probes" / "launch_floor.cu"
LAUNCH_FLOOR_ARGS = (_build.INT, _build.INT, _build.PTR)   # blocks, threads, stream


@functools.cache
def launch_floor_library() -> ctypes.CDLL:
    """``csrc/probes/launch_floor.cu``, an empty kernel on no path of the
    port, built with the port's nvcc flags and bound."""
    out = _build.BUILD_DIR / "liblaunch_floor.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(LAUNCH_FLOOR_SRC)], capture_output=True, text=True)
    check(proc.returncode == 0, f"nvcc failed on {LAUNCH_FLOOR_SRC}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.pmp_launch_floor.argtypes = list(LAUNCH_FLOOR_ARGS)
    lib.pmp_launch_floor.restype = ctypes.c_int
    return lib


def launch_floor(blocks: int, threads: int) -> None:
    """One launch of the empty kernel, ``blocks`` x ``threads``."""
    err = launch_floor_library().pmp_launch_floor(
        blocks, threads, torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"launch_floor kernel launch failed: CUDA error {err}")


def launch_floor_times(tag: str) -> dict:
    """The empty kernel's device time per call (CUDA graph of 50) at K1's
    and K7's launch shapes, {(blocks, threads): ms}: what any launch of that
    shape costs. K1 runs 4 warps a block (a 256-thread block per (CU, plane)
    before), K7 a team of P*P / 4 threads per (CU, plane)."""
    B = trd._BATCH_CUDA[8]
    shapes = ((1, 32), (1, 256), (4, 128), (16, 32), (16, 128), (16, 256), (32, 32),
              (32, 64), (32, 256), (B // 4, 128), (B // 2, 128), (B, 32), (B, 256),
              (2 * B, 256))
    out = {shape: graph_ms(functools.partial(launch_floor, *shape)) for shape in shapes}
    log(f"{tag} launch floor, an empty kernel per call (CUDA graph of 50): "
        + "; ".join(f"{b:,} x {t} threads {ms * 1e3:.3f} us" for (b, t), ms in out.items()))
    return out


# this tree's kernels built with their other shapes, timed beside the
# shipped one (4 warps a block, rounds of 32 entries for K1; a team of P*P /
# 4 threads per (CU, plane), int4 stores for K7; a cluster of 8 blocks per CU for K2, 4 for K3, of 16 warps,
# two blocks an SM; for K5 a cluster of one block a slot of 8 warps at the
# 32-pad class, one block an SM, 2 x 4 outputs a stage thread, the 8-pad
# class's slots one warp each of one block; for K6a a block of 4 warps per
# CU at the 16-pad class, 8 at the 32-pad, one warp per CU at the 4- and
# 8-pad classes; for K4 a block of 4 warps a round trip at the 16-pad class,
# 8 at the 32-pad, the trial's three on a cluster, 1 x 4 outputs a stage
# thread, one warp a round trip at the 4- and 8-pad classes, two blocks an
# SM there; for K9a a warp per rect and 4 rects a block at the 8-pad class,
# a block of 4, 8 and 16 warps per rect at the 16-, 32- and 64-pad classes;
# for K9b a warp per rect and 8 rects a block at the 8- and 16-pad classes,
# a block of 4 and 8 warps per rect at the 32- and 64-pad classes; for K9c
# a warp per rect and 8 rects a block at the 8- and 16-pad classes, a block
# of 4 and 8 warps per rect at the 32- and 64-pad classes; for K10c a warp
# per TU up to 128 samples, a block of a thread per 2 samples above, 2
# outputs a thread; for K10d up to 32 / rows candidates
# a warp, 2 warps a block, up to 4 warps a candidate of more rows):
# {label: nvcc defines}
K2_VARIANTS = {"one block per CU": ("-DK2_CLUSTER=1",),
               "4 blocks per CU": ("-DK2_CLUSTER=4",),
               "32 warps a block, one block an SM": ("-DK2_WARPS=32", "-DK2_BLOCKS_PER_SM=1")}
K3_VARIANTS = {"one block per CU": ("-DK3_CLUSTER=1",),
               "2 blocks per CU": ("-DK3_CLUSTER=2",),
               "8 blocks per CU": ("-DK3_CLUSTER=8",),
               "32 warps a block, one block an SM": ("-DK3_WARPS=32", "-DK3_BLOCKS_PER_SM=1")}
K5_VARIANTS = {"every slot in turn on one block": ("-DK5_SERIAL",),
               "1 x 4 outputs a stage thread": ("-DK5_STAGE_ROWS=1",),
               "two blocks an SM (64 registers)": ("-DK5_BLOCKS_PER_SM=2",),
               "8-pad: 4 blocks an SM (64 registers)": ("-DK5_TEAM_BLOCKS_PER_SM=4",),
               "8-pad: 2 blocks an SM (128 registers)": ("-DK5_TEAM_BLOCKS_PER_SM=2",),
               "4 warps a slot": ("-DK5_WARPS=4",),
               "16 warps a slot": ("-DK5_WARPS=16",),
               "8-pad slots on clusters too": ("-DK5_TEAM_PAD=0",)}
K4_VARIANTS = {"every round trip in turn on one block": ("-DK4_SERIAL",),
               "the trial's teams in one block, named barriers": ("-DK4_ONE_BLOCK",),
               "4 warps a team": ("-DK4_WARPS=4",),
               "16 warps a team": ("-DK4_WARPS=16",),
               "2 x 4 outputs a stage thread": ("-DK4_STAGE_ROWS=2",),
               "small pads: 3 blocks an SM (85 registers)": ("-DK4_TEAM_BLOCKS_PER_SM=3",),
               "small pads on blocks too": ("-DK4_TEAM_PAD=0",)}
K6A_VARIANTS = {"one block per CU at every pad": ("-DK6A_TEAM_PAD=0",),
                "4 warps a block": ("-DK6A_WARPS=4",),
                "8 warps a block": ("-DK6A_WARPS=8",),
                "16 warps a block": ("-DK6A_WARPS=16",)}
K1_VARIANTS = {"2 warps a block": ("-DK1_WARPS=2",),
               "8 warps a block": ("-DK1_WARPS=8",),
               "16 warps a block": ("-DK1_WARPS=16",)}
K7_VARIANTS = {"8 samples a thread": ("-DK7_BATCH=8",),
               "16 samples a thread": ("-DK7_BATCH=16",)}
K9A_VARIANTS = {"16-pad rects on warps too": ("-DK9A_TEAM_PAD=16",),
                "every rect on a block": ("-DK9A_TEAM_PAD=0",),
                "2 rects (warps) a block": ("-DK9A_WARPS=2",),
                "8 rects (warps) a block": ("-DK9A_WARPS=8",),
                "blocks of 2, 4, 8 warps (16-, 32-, 64-pad)": ("-DK9A_WARPS_LARGE=8",),
                "blocks of 8, 16, 32 warps (16-, 32-, 64-pad)": ("-DK9A_WARPS_LARGE=32",)}
K9B_VARIANTS = {"16 chroma pad on warps too": ("-DK9B_TEAM_PAD=16",),
                "every rect on a block": ("-DK9B_TEAM_PAD=0",),
                "8 rects (warps) a block": ("-DK9B_WARPS=8",),
                "16 rects (warps) a block": ("-DK9B_WARPS=16",),
                "blocks of 2, 4 warps (16, 32 chroma pad)": ("-DK9B_WARPS_LARGE=4",),
                "blocks of 8, 16 warps (16, 32 chroma pad)": ("-DK9B_WARPS_LARGE=16",)}
K9C_VARIANTS = {"16-pad rects on blocks": ("-DK9C_TEAM_PAD=8",),
                "every rect on a block": ("-DK9C_TEAM_PAD=0",),
                "32-pad rects on warps too": ("-DK9C_TEAM_PAD=32",),
                "4 rects (warps) a block": ("-DK9C_WARPS=4",),
                "16 rects (warps) a block": ("-DK9C_WARPS=16",),
                "blocks of 2, 4 warps (32-, 64-pad)": ("-DK9C_WARPS_LARGE=4",),
                "blocks of 8, 16 warps (32-, 64-pad)": ("-DK9C_WARPS_LARGE=16",)}
K10C_VARIANTS = {"4 outputs a thread, a warp up to 256 samples, 8 samples a thread above":
                 ("-DK10C_CW=4", "-DK10C_WARP_MAX=256", "-DK10C_EPT=8"),
                 "4 outputs a thread, 4 samples a thread above a warp": ("-DK10C_CW=4",
                                                                         "-DK10C_EPT=4"),
                 "a warp up to 256 samples (16x16 on a warp)": ("-DK10C_WARP_MAX=256",),
                 "a warp up to 32 samples (8x8 and 16x8 on blocks)": ("-DK10C_WARP_MAX=32",),
                 "4 samples a thread above a warp": ("-DK10C_EPT=4",)}
K10A_VARIANTS = {"8 warps a block": ("-DK10A_WARPS=8",),
                 "4 samples a thread at every size": ("-DK10A_SMALL=0",),
                 "one sample a thread up to 32x32": ("-DK10A_SMALL=1024",),
                 "small modes sharing warps in lane groups": ("-DK10A_LANE_GROUPS=1",)}
K10B_VARIANTS = {"one thread block per CU at every size": ("-DK10B_SAMPLES=65536",),
                 "a block per CU up to 16x16, 8 warps": ("-DK10B_SAMPLES=4096",
                                                         "-DK10B_WARPS=8"),
                 "one candidate a block at 4x4 too": ("-DK10B_SAMPLES=16",),
                 "8 warps a block": ("-DK10B_WARPS=8",)}
K10D_VARIANTS = {"one candidate a warp": ("-DK10D_CPW_MAX=1",),
                 "4 warps a block": ("-DK10D_WARPS=4",),
                 "8 warps a block": ("-DK10D_WARPS=8",),
                 "2 warps a candidate above a warp": ("-DK10D_WARPS_LARGE=2",),
                 "8 warps a candidate above a warp": ("-DK10D_WARPS_LARGE=8",)}
# K11a's build parameters (4 positions a thread, 64 threads a block
# shipped) and K12b's (1 quad a thread, 256 threads a block shipped)
K11A_VARIANTS = {"1 position a thread": ("-DK11A_PPT=1",),
                 "2 positions a thread": ("-DK11A_PPT=2",),
                 "32 threads a block": ("-DK11A_THREADS=32",),
                 "128 threads a block": ("-DK11A_THREADS=128",),
                 "256 threads a block": ("-DK11A_THREADS=256",)}
K12B_VARIANTS = {"2 quads a thread": ("-DK12B_QPT=2",),
                 "4 quads a thread": ("-DK12B_QPT=4",),
                 "128 threads a block": ("-DK12B_THREADS=128",),
                 "512 threads a block": ("-DK12B_THREADS=512",)}
# K8's (16 lanes a CTU, 256 threads a block shipped) and K10e's (teams of
# one warp 4 a block up to 64 int4s, 16x16, at up to 2 a lane; above, 1 a
# lane: 8 warps at 32x32, 32 at 64x64)
K8_VARIANTS = {"8 lanes a CTU, both rows a lane": ("-DK8_LANES=8",),
               "128 threads a block": ("-DK8_THREADS=128",),
               "8 lanes a CTU, 128 threads a block": ("-DK8_LANES=8", "-DK8_THREADS=128")}
K10E_VARIANTS = {"8 warps a block": ("-DK10E_WARPS=8",),
                 "2 warps a block": ("-DK10E_WARPS=2",),
                 "1 int4 a lane at 16x16 (2 warps)": ("-DK10E_WARP_UNITS=32",),
                 "2 int4s a lane in teams (32x32 on 4 warps, 64x64 on 16)": ("-DK10E_LPL=2",)}
# (label, bound ms) of the timed cases that carry one, by (kernel, label)
CASE_BOUNDS: dict = {}
K11A_CASES = (("qbd", 22, True, 32), ("qbd", 22, True, 64), ("bd", 37, False, 64),
              ("q", 22, True, 64), ("qbd", 27, True, 7), ("qbd", 27, True, 257))


def k11a_cases(width: int, height: int) -> list:
    """``phase_variant_times``' cases of K11a: mode qbd, luma, at batch 32
    (the training path's) and 64 (``cli/train.py``'s default), bd chroma at
    QP 37 and q at batch 64, qbd at batch 7 and 257, whose positions fill no
    whole block or thread group; ``width`` and ``height`` unused."""
    out = []
    for k, (mode, qp, is_luma, n) in enumerate(K11A_CASES):
        label = f"mode {mode}, QP {qp}, {'luma' if is_luma else 'chroma'}, batch {n}"
        CASE_BOUNDS[("k11a", label)] = train_bounds("qbd_loss", n, mode)[:2]
        out.append((label, functools.partial(k11a_call, mode, qp, is_luma, n, 90 + k)))
    return out


K12B_SHAPES = ((256, 512, 2, 0), (256, 512, 2, 1), (256, 512, 4, 1), (128, 256, 1, 0),
               (2160, 3840, 2, 0), (1080, 1920, 3, 1))   # (H, W, stripes, rank)


def k12b_cases(width: int, height: int) -> list:
    """``phase_variant_times``' cases of K12b: the pack and the unpack of
    one step at 512x256 over 2 stripes (ranks 0 and 1), over 4 (an interior
    rank), 256x128 on one stripe (its unpack launches nothing: pack only),
    3840x2160 over 2 stripes (rank 0) and 1920x1080 over 3 (rank 1, both
    neighbours); ``width`` and ``height`` unused."""
    out = []
    for k, (H, W, D, me) in enumerate(K12B_SHAPES):
        has = (me > 0, me < D - 1)
        for what in ("pack", "unpack") if D > 1 else ("pack",):
            label = f"{what}, {W}x{H} over {D} stripe{'s' if D > 1 else ''}, rank {me}"
            bound_ms = halo_bounds(H, *has)[f"halo_{what}"][0]
            CASE_BOUNDS[("k12b", label)] = (bound_ms, "bytes")
            out.append((label, functools.partial(halo_call, what, H, W // D, *has, 200 + k)))
    return out


K8_CASES = ((BATCH, "the prediction path's chunk"), (508, "the path's last chunk of a frame"),
            (8, "entry()'s example"), (VOTE_N, "phase 2's maps, 33.5 MB: held in the 50 MB L2"),
            (8 * VOTE_N, "268 MB, beyond L2"))


def k8_call(n: int):
    """(K8 on ``vote_inputs(n)`` on the card, its plain version's outputs)."""
    x = torch.from_numpy(vote_inputs(n, seed=n)).to(DEVICE)
    return (lambda: [structural_vote(x)]), [structural_vote_reference(x)]


def k8_cases(width: int, height: int) -> list:
    """``phase_variant_times``' cases of K8: N = 512 and 508 (the
    prediction path's two chunk sizes at 1920x1080), 8 (``entry()``'s),
    65,536 (its maps stay in L2 between the graph's calls) and 524,288
    (streaming from device memory); ``width`` and ``height`` unused."""
    out = []
    for n, what in K8_CASES:
        label = f"N = {n} ({what})"
        x = torch.from_numpy(vote_inputs(n, seed=n)).to(DEVICE)
        CASE_BOUNDS[("k8", label)] = vote_bound(x)[:2]
        out.append((label, functools.partial(k8_call, n)))
    return out


K10E_CASES = ((16, 16, 67, False), (4, 4, 67, False), (32, 32, 16, True), (64, 64, 8, True))


def k10e_call(fn, w: int, h: int, k: int, per_block: bool):
    """(``fn`` (K10e's sad or sse) on k random blocks of w x h against one
    original or one each, its plain version's outputs)."""
    rng = np.random.RandomState(w * 131 + h + k)
    org = torch.from_numpy(rng.randint(0, 1024, (k if per_block else 1, h, w))
                           .astype(np.int32)).to(DEVICE)
    cur = torch.from_numpy(rng.randint(0, 1024, (k, h, w)).astype(np.int32)).to(DEVICE)
    plain = dist_ops.sad_reference if fn is dist_ops.sad else dist_ops.sse_reference
    return (lambda: [fn(org, cur)]), [plain(org, cur)]


def k10e_cases(width: int, height: int) -> list:
    """``phase_variant_times``' cases of K10e: ``sad`` and ``sse`` on 67
    blocks of 16x16 and of 4x4 against one original (RMD's count), on 16 of
    32x32 and 8 of 64x64 with an original each (the block form); ``width``
    and ``height`` unused."""
    out = []
    for fn, (w, h, k, per) in itertools.product((dist_ops.sad, dist_ops.sse), K10E_CASES):
        label = f"{fn.__name__}, {k} of {w}x{h}" + (", an original each" if per else "")
        CASE_BOUNDS[("k10e", label)] = seq_bounds(f"seq_{fn.__name__}", w, h, k,
                                                  n=k if per else 1)[:2]
        out.append((label, functools.partial(k10e_call, fn, w, h, k, per)))
    return out


# K10e's untimed edge cases, held exactly to the plain versions on every build
K10E_EDGE_CASES = ("k10e_inputs: every side 2..64 against one original and one each, the "
                   "wrapping sums, the int32 limits",
                   "views off the 16-byte grain and 3x5 blocks: the scalar instantiation")


def k10e_edge_variant_checks() -> list:
    """``K10E_EDGE_CASES`` (``k10e_inputs``) as one ``VARIANT_CHECKS``
    entry: ``sad`` and ``sse`` of every pair."""
    def make():
        pairs = k10e_inputs(np.random.RandomState(11))
        fns = ((dist_ops.sad, dist_ops.sad_reference), (dist_ops.sse, dist_ops.sse_reference))
        return ((lambda: [fn(o, c) for o, c in pairs for fn, _ in fns]),
                [plain(o, c) for o, c in pairs for _, plain in fns])
    return [("K10E_EDGE_CASES", make)]


# ``--k1-times`` / ``--k2-times`` / ``--k3-times`` / ``--k4-times`` /
# ``--k5-times`` / ``--k6a-times`` / ``--k7-times`` / ``--k9a-times`` /
# ``--k9b-times`` / ``--k9c-times`` / ``--k10a-times`` / ``--k10b-times`` /
# ``--k10c-times`` / ``--k10d-times`` / ``--k11a-times`` / ``--k12b-times`` /
# ``--k8-times`` / ``--k10e-times``: (library, wrapper module,
# variants, the function that gives the timed cases: (label, the function
# that makes the call, its plain outputs and, for a kernel that writes in
# place, the function that clears what it writes))
TIMED_KERNELS = {"k1": ("ref_gather", ig, K1_VARIANTS, k1_cases),
                 "k2": ("intra_rmd", ig, K2_VARIANTS, class_cases(k2_call, TIMED_CLASSES)),
                 "k3": ("mip_rmd", mip_g, K3_VARIANTS,
                        class_cases(k3_call, tuple(c for c in TIMED_CLASSES if c[1] == 1))),
                 "k4": ("tq", ttq, K4_VARIANTS, k4_cases),
                 "k5": ("tq_mts", ttq, K5_VARIANTS, k5_cases),
                 "k6a": ("cclm", cclm_g, K6A_VARIANTS, k6a_cases),
                 "k7": ("wave_scatter", wf, K7_VARIANTS, class_cases(k7_call, TIMED_CLASSES)),
                 "k9a": ("rdo_leaf", rg, K9A_VARIANTS, k9a_cases),
                 "k9b": ("rdo_leaf", rg, K9B_VARIANTS, k9b_cases),
                 "k9c": ("rdo_leaf", rg, K9C_VARIANTS, k9c_cases),
                 "k10a": ("seq_intra", intra_ops, K10A_VARIANTS, k10a_cases),
                 "k10b": ("seq_mip", mip_ops, K10B_VARIANTS, k10b_cases),
                 "k10c": ("seq_tq", quant_ops, K10C_VARIANTS, k10c_cases),
                 "k10d": ("seq_satd", dist_ops, K10D_VARIANTS, k10d_cases),
                 "k11a": ("qbd_loss", tg, K11A_VARIANTS, k11a_cases),
                 "k12b": ("halo", sp, K12B_VARIANTS, k12b_cases),
                 "k8": ("structural_vote", vote_mod, K8_VARIANTS, k8_cases),
                 "k10e": ("seq_dist", dist_ops, K10E_VARIANTS, k10e_cases)}
# untimed inputs on which every build of ``phase_variant_times`` must equal
# the plain version too: (label, the function that makes the call and its
# plain outputs)
VARIANT_CHECKS = {"k9a": k9a_tie_cases, "k9b": k9b_tie_cases, "k9c": k9c_edge_cases,
                  "k10a": k10a_edge_variant_checks, "k10b": k10b_edge_variant_checks,
                  "k10c": k10c_edge_variant_checks,
                  "k10d": k10d_edge_variant_checks, "k11a": k11a_edge_variant_checks,
                  "k12b": k12b_edge_variant_checks, "k8": k8_edge_variant_checks,
                  "k10e": k10e_edge_variant_checks}
# the comparison with the plain version where it is not exact equality
VARIANT_CMP = {"k11a": k11a_cmp}


class ParentK11a:
    """The parent commit's K11a library behind this tree's entry points: its
    ``pmp_qbd_loss`` (two kernels) takes no ticket counter, and its grid is
    a block per 256 label positions."""
    SIGNATURES = {"pmp_qbd_loss": (_build.INT, _build.INT) + (_build.PTR,) * 15}

    def __init__(self, lib):
        self.lib = lib

    @staticmethod
    def pmp_qbd_loss_blocks(mode: int, n: int) -> int:
        return -(-n * (64 if mode == 0 else 256) // 256)

    def pmp_qbd_loss(self, *args):
        return self.lib.pmp_qbd_loss(*args[:15], *args[16:])    # the counter is args[15]


# a parent library whose entry points differ: (its signatures, the adapter)
PARENT_FORMS = {"k11a": (ParentK11a.SIGNATURES, ParentK11a)}


def parent_library(kernel: str, parent: pathlib.Path):
    """``kernel``'s library built from the parent checkout ``parent``,
    behind this tree's entry points."""
    name = TIMED_KERNELS[kernel][0]
    signatures, adapt = PARENT_FORMS.get(kernel, (None, lambda lib: lib))
    return adapt(variant_library(kernel, parent / "pmp_vvc_tpu_torch" / "csrc" / f"{name}.cu",
                                 parent / "build" / "kernels" / f"lib{name}-parent.so",
                                 signatures=signatures))


def phase_variant_times(kernel: str, parent: pathlib.Path, width: int = 256,
                        height: int = 192) -> dict:
    """``kernel``'s (``TIMED_KERNELS``) device time per call (CUDA graph)
    on its timed cases, for the parent commit's source (``parent``: a
    checkout of it; its ``csrc/<library>.cu`` built into its own
    ``build/``), this tree's, and this tree's built with each of its
    variants' defines (the builds in parallel), in turns: parent, new, the
    variants, the variants again in reverse, new, parent. Each equals the
    plain version on those inputs and on ``VARIANT_CHECKS``' ones."""
    name, _, variants, make_cases = TIMED_KERNELS[kernel]
    tag = f"[{kernel}-times]"
    jobs = {label: (_build.CSRC / f"{name}.cu", _build.BUILD_DIR / f"lib{name}-variant{i}.so",
                    defines) for i, (label, defines) in enumerate(variants.items())}
    with ThreadPoolExecutor(max_workers=len(jobs) + 1) as pool:
        parent_lib = pool.submit(parent_library, kernel, parent)
        built = dict(zip(jobs, pool.map(lambda j: variant_library(kernel, *j), jobs.values())))
        libs = {"parent": parent_lib.result(), "new": None, **built}
    order = ("parent", "new", *variants, *reversed(variants), "new", "parent")
    cmp = VARIANT_CMP.get(kernel, _cmp)
    errs: dict = {}
    for cls, make in VARIANT_CHECKS.get(kernel, list)():
        call, want = make()
        for label, lib in libs.items():
            with launching(kernel, lib):
                cmp(f"{name} ({label})", list(call()), want, errs)
        log(f"{tag} {cls}: every build equal to the plain version")
    res = {}
    cases = make_cases(width, height)
    graph_ms(cases[0][1]()[0])      # untimed: the card's first replays run at another clock
    for cls, make in cases:
        call, want, *reset = make()
        times = collections.defaultdict(list)
        for label in order:
            with launching(kernel, libs[label]):
                for clear in reset:
                    clear()
                cmp(f"{name} ({label})", list(call()), want, errs)
                times[label].append(graph_ms(call))
        res[cls] = {label: t for label, t in times.items()}
        new, old = min(times["new"]), min(times["parent"])
        bound = CASE_BOUNDS.get((kernel, cls))
        share = "" if bound is None else (
            f"; bound {bound[0] * 1e3:.4f} us by {bound[1]}, share new "
            f"{100 * bound[0] / new:.1f}%, parent {100 * bound[0] / old:.1f}%")
        log(f"{tag} {cls}: device time per call (CUDA graph of 50) "
            + "; ".join(f"{label} " + " / ".join(f"{t * 1e3:.3f}" for t in ts) + " us"
                        for label, ts in times.items())
            + f"; parent / new {old / new:.2f}x{share}")
    log(f"{tag} every variant equal to the plain version (max_abs_err {errs})")
    launch_floor_times(tag)
    return res


def phase_rdo_l0(kernel: str, parent: pathlib.Path) -> None:
    """The RDO's main path (phase 13's 1080p x 2 encode at L0 with
    ``rdo_fallback``), warm, with the parent commit's K9 library
    (``parent``'s ``rdo_leaf.cu``: its K9a, K9b and K9c) and this one in
    turns (parent, new, new, parent), for ``kernel`` (k9a, k9b or k9c):
    each run's ``rdo_leaf_device`` span and wall time; the four streams must
    be equal."""
    tag = f"[{kernel}-times]"
    lib = variant_library(kernel, parent / "pmp_vvc_tpu_torch" / "csrc" / "rdo_leaf.cu",
                          parent / "build" / "kernels" / "librdo_leaf-parent.so")
    preds = {(comp, ENC_QP): CompPredictor.from_trained(
                 comp == "Luma", CKPT / f"{comp}_Q_QP{ENC_QP}.msgpack",
                 CKPT / f"{comp}_BD_QP{ENC_QP}.msgpack", device=DEVICE)
             for comp in ("Luma", "Chroma")}
    frames = natural_sequence(ENC_W, ENC_H, ENC_FRAMES, seed0=7, bit_depth=BD)
    maps_l, maps_c = frame_maps(preds, frames, ENC_W, ENC_H)
    enc = wf.WavefrontEncoder(enc_cfg(ENC_W, ENC_H), accel_level=0, rdo_fallback=True,
                              device=DEVICE)
    enc.encode_frames(frames, maps=maps_l, chroma_maps=maps_c)   # cold: the node DAGs
    streams = []
    for label in ("parent", "new", "new", "parent"):
        with launching(kernel, lib if label == "parent" else None):
            outs = timed_encode(enc, frames, maps_l, maps_c, f"{MAIN} at L0, K9 {label}")
        streams.append(b"".join(o[0] for o in outs))
        log(f"{tag} L0 path with the {label} K9 library: rdo_leaf_device "
            f"{enc.timings['rdo_leaf_device']:.6f} s")
    check(len(set(streams)) == 1, "the L0 path's stream differs between the parent's K9 "
                                  "and this one")
    log(f"{tag} L0 path: the four streams byte-identical")


def phase_k10_seq(kernel: str, parent: pathlib.Path) -> None:
    """Phase 20's sequential encode: both 416x240 frames cold, counting the
    path's call mix, then the first frame warm with the parent commit's
    K10a, K10b, K10c or K10d (``parent``'s source) and this one in turns (parent, new,
    new, parent): each run's ``code`` time and wall; the four streams
    byte-identical, each hash SEI its recon's MD5; the mix's every entry
    timed for both kernels, and each one's lost time (``seq_mix_times``)."""
    name = TIMED_KERNELS[kernel][0]
    lib = variant_library(kernel, parent / "pmp_vvc_tpu_torch" / "csrc" / f"{name}.cu",
                          parent / "build" / "kernels" / f"lib{name}-parent.so")
    preds = {(comp, ENC_QP): CompPredictor.from_trained(
                 comp == "Luma", CKPT / f"{comp}_Q_QP{ENC_QP}.msgpack",
                 CKPT / f"{comp}_BD_QP{ENC_QP}.msgpack", device=DEVICE)
             for comp in ("Luma", "Chroma")}
    frames = natural_sequence(SEQ_W, SEQ_H, SEQ_FRAMES, seed0=7, bit_depth=BD)
    maps_l, maps_c = frame_maps(preds, frames, SEQ_W, SEQ_H)
    enc = FrameEncoder(enc_cfg(SEQ_W, SEQ_H, SEQ), mode_select="satd", device=DEVICE)
    with seq_call_mix() as mixes:                               # cold, every frame
        seq_encode(enc, frames, maps_l, maps_c)
    streams = []
    for label in ("parent", "new", "new", "parent"):
        with launching(kernel, lib if label == "parent" else None):
            enc.timings = {}
            t0 = time.perf_counter()
            bs, recon = seq_encode(enc, frames[:1], maps_l, maps_c)[0]
            wall = time.perf_counter() - t0
        want = [hashlib.md5(p.astype("<u2").tobytes()).digest() for p in recon]
        check(sei_md5s(bs) == [want], f"K10 {label}: hash SEI differs from the recon's MD5")
        streams.append(bs)
        log(f"[{kernel}-times] sequential path ({SEQ_W}x{SEQ_H}, 1 frame) with {name} {label}: "
            f"code {enc.timings['code']:.6f} s, wall {wall:.6f} s")
    check(len(set(streams)) == 1, f"the sequential stream differs between the parent's {name} "
                                  f"and this one")
    log(f"[{kernel}-times] sequential path: the four streams byte-identical "
        f"({len(streams[0])} bytes), every hash SEI its recon's MD5")
    if kernel == "k10a":
        pairs = k10a_pair_calls(mixes["k10a"])
        log(f"[k10a-times] sequential path ({SEQ_FRAMES} frame(s)): {sum(mixes['k10a'].values())} K10a "
            f"launches, {pairs} of them a chroma CU's U and V in one call: "
            f"{sum(mixes['k10a'].values()) + pairs} with a call a plane")
    seq_mix_times(mixes, f"[{kernel}-times]", {"parent": lib, "new": None}, (kernel,))


def phase_k11a_train(parent: pathlib.Path, steps: int = 4, timed: int = 20) -> None:
    """The training path's luma joint step (``dp_train``: the committed QP
    22 nets, batch 32, seeded float samples) under cuDNN's deterministic
    algorithms with the parent commit's K11a library and this one in turns
    (parent, new, new, parent): ``steps`` steps' losses and parameters,
    equal in every run, then the warm steps/s of ``timed`` more."""
    lib = parent_library("k11a", parent)
    batches = dp_batches(steps)
    runs = []
    with cudnn_deterministic():
        for label in ("parent", "new", "new", "parent"):
            with launching("k11a", lib if label == "parent" else None):
                out = dp_train(batches, timed=timed)
            runs.append(out)
            log(f"[k11a-times] luma joint step, batch {TRAIN_BATCH}, K11a {label}: "
                f"{out['steps_per_s']:.2f} warm steps/s; losses {out['losses']}")
    check(all(r["losses"] == runs[0]["losses"] for r in runs),
          "the joint step's losses differ between the parent's K11a and this one")
    check(all(np.array_equal(r["params"][steps], runs[0]["params"][steps]) for r in runs),
          "the joint step's parameters differ between the parent's K11a and this one")
    log(f"[k11a-times] luma joint step: the four runs' losses and parameters after {steps} "
        f"steps bit-equal")


def times_only(kernel: str, parent: pathlib.Path) -> int:
    """``--k1-times PARENT`` / ``--k2-times PARENT`` / ``--k3-times PARENT``
    / ``--k4-times PARENT`` / ``--k5-times PARENT`` / ``--k6a-times PARENT``
    / ``--k7-times PARENT`` / ``--k9a-times PARENT`` / ``--k9b-times
    PARENT`` / ``--k9c-times PARENT`` / ``--k10a-times PARENT`` /
    ``--k10b-times PARENT`` / ``--k10c-times PARENT`` / ``--k10d-times
    PARENT`` / ``--k11a-times PARENT`` / ``--k12b-times PARENT`` /
    ``--k8-times PARENT`` / ``--k10e-times PARENT``: the build; for K11a
    phase 17's checks and times (``phase_train_kernels``), for K12b phase
    23's (``phase_halo_kernels``), for K8 phase 2's (``phase_vote``), for
    K10e phase 19's (``phase_seq_kernels``); for the others the encode
    kernels' checks and times (the K2, K3, K4, K5 and K6a tie cases and K1's
    and K7's edge cases among them, and the launch floor; K5's time shows
    what K4's shared ``csrc/tq_team.cuh`` left of it), for K1, K4, K6a and
    K9a-c the device RDO's kernel checks and times (all on the RDO's path,
    K9a and K9b with their tie cases, K9c with its edge cases; K9 shares
    ``csrc/satd.cuh``), K10a-e's checks and times (K10a shares K2's and
    K9's ``csrc/intra_pred.cuh``, K10b K3's ``csrc/mip.cuh``, K10c
    ``csrc/tq.cuh``, K10d ``csrc/satd.cuh``),
    ``phase_variant_times`` against the parent checkout, for K9a-c the L0
    path with the parent's K9 library and this one (``phase_rdo_l0``), for
    K10a-d the sequential path with the parent's kernel and this one
    (``phase_k10_seq``), for K11a the training step with the parent's
    library and this one (``phase_k11a_train``); prints no result line."""
    phase_build()
    log(f"[{kernel}-times] int32 rate {int32_ops_per_s():.6e} ops/s")
    if kernel == "k11a":
        phase_train_kernels()
    elif kernel == "k12b":
        phase_halo_kernels()
    elif kernel == "k8":
        phase_vote()
    elif kernel == "k10e":
        phase_seq_kernels()
    else:
        phase_encode_kernels()
        if kernel in ("k1", "k4", "k6a", "k9a", "k9b", "k9c"):
            phase_rdo_kernels()
        phase_seq_kernels()
    phase_variant_times(kernel, parent)
    if kernel == "k11a":
        phase_k11a_train(parent)
    if kernel in ("k9a", "k9b", "k9c"):
        phase_rdo_l0(kernel, parent)
    if kernel in ("k10a", "k10b", "k10c", "k10d"):
        phase_k10_seq(kernel, parent)
    log(card_line())
    log(f"[{kernel}-times] partial run: no result line")
    return 0


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def md_only() -> int:
    """``--md-only``: the build and the multi-device phases alone, for
    iterating on them; prints no result line."""
    phase_build()
    phase_halo_kernels()
    preds = {(comp, ENC_QP): CompPredictor.from_trained(
                 comp == "Luma", CKPT / f"{comp}_Q_QP{ENC_QP}.msgpack",
                 CKPT / f"{comp}_BD_QP{ENC_QP}.msgpack", device=DEVICE)
             for comp in ("Luma", "Chroma")}
    with tempfile.TemporaryDirectory(prefix="pmp_chip_smoke_md_") as tmp:
        phase_md_2rank(phase_md_nccl1(preds, pathlib.Path(tmp)), pathlib.Path(tmp))
    phase_dp_kernels()
    with tempfile.TemporaryDirectory(prefix="pmp_chip_smoke_dp_") as tmp:
        phase_dp_2rank(phase_dp_nccl1(pathlib.Path(tmp)), pathlib.Path(tmp))
    log(card_line())
    log("[multidevice-only] partial run: no result line")
    return 0


def seq_only() -> int:
    """``--seq-only``: the build and the sequential engine's phases alone,
    for iterating on them; prints no result line."""
    phase_build()
    phase_seq_kernels()
    preds = {("Luma", ENC_QP): CompPredictor.from_trained(
                 True, CKPT / f"Luma_Q_QP{ENC_QP}.msgpack",
                 CKPT / f"Luma_BD_QP{ENC_QP}.msgpack", device=DEVICE),
             ("Chroma", ENC_QP): CompPredictor.from_trained(
                 False, CKPT / f"Chroma_Q_QP{ENC_QP}.msgpack",
                 CKPT / f"Chroma_BD_QP{ENC_QP}.msgpack", device=DEVICE)}
    seq_streams = {"sequential path": phase_seq_encode(preds)[1]}
    with phase_seq_rdo(preds) as rdo:
        seq_streams["sequential, CPU against card"] = phase_seq_cpu_vs_card(preds)
        with tempfile.TemporaryDirectory(prefix="pmp_chip_smoke_cli_") as tmp:
            seq_streams.update(phase_cli(pathlib.Path(tmp)))
    seq_streams.update(rdo["streams"])
    phase_seq_decode(seq_streams)
    log(card_line())
    log("[seq-only] partial run: no result line")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    if sys.argv[1:] == ["--seq-only"]:
        return seq_only()
    if sys.argv[1:2] == ["--md-rank"]:
        return md_child(int(sys.argv[2]), pathlib.Path(sys.argv[3]))
    if sys.argv[1:2] == ["--dp-rank"]:
        return dp_child(int(sys.argv[2]), pathlib.Path(sys.argv[3]))
    if sys.argv[1:] == ["--md-only"]:
        return md_only()
    if sys.argv[1:2] in (["--k1-times"], ["--k2-times"], ["--k3-times"], ["--k4-times"],
                         ["--k5-times"], ["--k6a-times"], ["--k7-times"], ["--k9a-times"],
                         ["--k9b-times"], ["--k9c-times"], ["--k10a-times"], ["--k10b-times"],
                         ["--k10c-times"], ["--k10d-times"], ["--k11a-times"],
                         ["--k12b-times"], ["--k8-times"], ["--k10e-times"]):
        return times_only(sys.argv[1][2:].removesuffix("-times"), pathlib.Path(sys.argv[2]))
    phase_build()
    vote = phase_vote()
    enc_errs, enc_times = phase_encode_kernels()
    rdo_errs, rdo_times = phase_rdo_kernels()
    train_errs, train_times = phase_train_kernels()
    seq_errs, seq_times = phase_seq_kernels()
    md_errs, md_times = phase_halo_kernels()
    dp_errs, dp_times = phase_dp_kernels()
    with tempfile.TemporaryDirectory(prefix="pmp_chip_smoke_") as tmp:
        preds, blocks, launches = phase_main_path(pathlib.Path(tmp))
    phase_cpu_vs_card(preds, blocks)
    phase_profile(preds, blocks)
    enc_l3, frames, maps_l, maps_c, enc_launches = phase_encode(preds)
    step_errs = phase_encode_first_steps(frames, maps_l, maps_c)
    rdo_launches = phase_rdo_encode(frames, maps_l, maps_c, enc_l3)
    bench_stream = phase_encode_bench_tools(preds)
    phase_rdo_bench(preds)
    phase_rdo_labels()
    with tempfile.TemporaryDirectory(prefix="pmp_chip_smoke_train_") as tmp:
        train_launches = phase_train(pathlib.Path(tmp))
    seq_launches, seq_stream = phase_seq_encode(preds)
    seq_streams = {"sequential path": seq_stream}
    with phase_seq_rdo(preds) as rdo:       # phases 29-30 in workers beside 10, 16, 21, 22
        phase_encode_cpu_vs_card(preds)
        phase_rdo_cpu_vs_card()
        seq_streams["sequential, CPU against card"] = phase_seq_cpu_vs_card(preds)
        with tempfile.TemporaryDirectory(prefix="pmp_chip_smoke_cli_") as tmp:
            seq_streams.update(phase_cli(pathlib.Path(tmp)))
    rdo_seq_launches = rdo["launches"]
    seq_streams.update(rdo["streams"])
    seq_streams["wave path, bench configuration"] = bench_stream
    decode_launches = phase_seq_decode(seq_streams)
    with tempfile.TemporaryDirectory(prefix="pmp_chip_smoke_md_") as tmp:
        nccl1 = phase_md_nccl1(preds, pathlib.Path(tmp))
        two = phase_md_2rank(nccl1, pathlib.Path(tmp))
    with tempfile.TemporaryDirectory(prefix="pmp_chip_smoke_dp_") as tmp:
        dp1 = phase_dp_nccl1(pathlib.Path(tmp))
        dp2 = phase_dp_2rank(dp1, pathlib.Path(tmp))
    phase_encode_profile(frames, maps_l, maps_c)

    kernels = [{
        "name": "structural_vote", "route": "cuda",
        "source": "pmp_vvc_tpu_torch/csrc/structural_vote.cu",
        "replaces": "pmp_vvc_tpu/pmp/structural.py:39",
        "launches": launches, "max_abs_err": vote["max_abs_err"],
        **vote[BATCH], "library_ms": None,
    }]
    # library_ms is null: no single PyTorch call computes any of these
    # functions (the reference substitution, the 67-mode predictor with its
    # SATD argmin, the MIP candidates with their SATD argmin, the integer
    # transform-quantisation round trip with sign-data hiding, the joint
    # Cb-Cr trial and the chroma residual scale from its VPDU's neighbours,
    # the candidate round trips of MTS, LFNST and transform skip with their
    # cost argmin, the CCLM template fit with its SATD choice, or the step's
    # masked scatters with their index arithmetic).
    sources = {name: (source, replaces) for name, (_, source, replaces) in ENC_KERNELS.items()}
    sources[K6B[0]] = K6B[1:]
    for name, (source, replaces) in sources.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": enc_launches[name],
            "max_abs_err": max(enc_errs[name], step_errs.get(name, 0.0),
                               rdo_errs.get(name, 0.0)),
            **enc_times[name], "library_ms": None})
    # K9: no single PyTorch call computes an RMD argmin over predicted modes
    # or a leaf cost of exact SSEs and this rate proxy; launches are the
    # RDO path's (phase_rdo_encode)
    for name, (_, source, replaces) in RDO_KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": rdo_launches[name], "max_abs_err": rdo_errs[name],
            **rdo_times[name], "library_ms": None})
    # K11a: no single PyTorch call computes this weighted multi-branch loss
    # and its gradient; K11b's library time is torch.optim.Adam(fused=True)
    for name, (_, source, replaces) in TRAIN_KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": train_launches[name], "max_abs_err": train_errs[name],
            **train_times[name]})
    # K10: no single PyTorch call computes one block's intra predictions for
    # a list of modes, the MIP candidates, the integer transform-quantisation
    # stages, the tiled Hadamard SATD, or a block's int32 sum of |org - cur|
    # or its square that wraps (PyTorch's integer sums promote to int64, and
    # its distance calls take floats); launches are the sequential path's
    # warm run (phase_seq_encode), 0 for K10e, which no path calls; K10e's
    # sad has torch.cdist(p=1) on float32 copies as its library yardstick;
    # K10a-d's launches on the RDO split search's runs and K10a-c's over the
    # decodes beside them
    for name, (_, source, replaces) in [*SEQ_KERNELS.items(), *K10E_KERNELS.items()]:
        by_path = {f"rdo search, {label}": n[name] for label, n in rdo_seq_launches.items()
                   if name in n}
        if name in decode_launches:
            by_path["decode"] = decode_launches[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": seq_launches[name], "max_abs_err": seq_errs[name],
            "library_ms": None, **seq_times[name],
            **({"launches_by_path": by_path} if by_path else {})})
    # K12b: no PyTorch call computes a masked pack of six plane bands;
    # launches are the two-rank spatial path's (rank 0)
    for name, (_, source, replaces) in MD_KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": two["spatial_launches"][name], "max_abs_err": md_errs[name],
            **md_times[name], "library_ms": None})
    # K12c: no single PyTorch call packs and scales a table of tensors;
    # launches are the one-rank NCCL mesh's DP_STEPS training steps
    for name, (_, source, replaces) in DP_KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": dp1["launches"][name], "max_abs_err": dp_errs[name],
            **dp_times, "library_ms": None})
    # K12a is no kernel of its own: each rank runs K1-K7 on its block of the
    # step and one all-gather per pass; its launches under each mesh
    k12a = {"replaces": K12A_REPLACES, "launches": {
        "nccl, 1 rank": {k: nccl1["launches"][k] for k in ENC_KERNELS},
        f"{two['transport']}, 2 ranks (rank 0)": {k: two["bench_launches"][k]
                                                  for k in ENC_KERNELS}},
        "all_gather_ms": {"nccl, 1 rank": nccl1["times"]["all_gather"],
                          f"{two['transport']}, 2 ranks": two["times"]["all_gather"]},
        "exchange_ms": {"nccl, 1 rank": nccl1["times"]["exchange"],
                        f"{two['transport']}, 2 ranks": two["times"]["exchange"]}}
    # K12c's data-parallel CNN under each mesh: the predictor's and the
    # step's rates, the all-reduce of the gradient bucket per step
    k12c = {"ctus_per_s": {"meshless": dp1["meshless_ctus_per_s"],
                           "nccl, 1 rank": dp1["mesh_ctus_per_s"],
                           f"{dp2['transport']}, 2 ranks (rank 0)": dp2["ctus_per_s"]},
            "steps_per_s": {"meshless": dp1["train_meshless"]["steps_per_s"],
                            "nccl, 1 rank": dp1["train_mesh"]["steps_per_s"],
                            f"{dp2['transport']}, 2 ranks (rank 0)":
                                dp2["train"]["steps_per_s"]},
            "all_reduce_ms": {"nccl, 1 rank": dp1["all_reduce_ms"],
                              f"{dp2['transport']}, 2 ranks": dp2["all_reduce_ms"]}}
    log(json.dumps({"kernels": kernels, "k12a": k12a, "k12c": k12c}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
