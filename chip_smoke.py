#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (learning3d_tpu_torch) on one card.

    python3 chip_smoke.py

Drives the port's main paths at full width, bf16 and int8 (post-training
quantized) eval serving of the PointNet-1024 classifier and of DCP
registration (DGCNN-512, the co-attention pointer and the SVD head), bf16
serving of iPCRNet with multi-start registration, f32 serving of PRNet
(with multi-start registration), of FlowNet3D and of RPMNet, MaskNet filtering for PointNetLK, f32
serving of PointConv and CurveNet, bf16 serving of the DGCNN classifier, and training
of the PointNet-1024 classifier, DCP, iPCRNet, PCN, PRNet, FlowNet3D,
RPMNet, PointNetLK, MaskNet, part segmentation, PointConv, CurveNet, the
DGCNN classifier, DeepGMR and MaskNet2 (both also served) through the
Trainer, runs the port's train and evaluate entry points (the trained
PointNet classifier held to the JAX package's predictions), runs the
trained RPMNet and FlowNet3D against the JAX package's stored results, and
holds every CUDA kernel of those paths against its plain PyTorch version.
Phases, one JSON line each with the seconds since start:

1. device: the card, and its name and power limit from nvidia-smi;
2. build: every kernel compiled from the checkout's sources, one nvcc
   process a source, all at once, and one link, into a fresh build
   directory (seconds, ptxas register report);
3. kernel: K1 against its plain version at B=256, N=1024, emb=1024, on a
   ragged B=3, N=1000 cloud and at iPCRNet's serving chunk (B=32); times of
   the kernel, the plain version, the eager bf16 cuBLAS chain (the
   yardstick, as ``library_ms``) and the bound, at B=256 and at B=32;
4. serve: Classifier(PointNet(1024, use_bn=True)) in bf16 eval with
   numpy-seeded weights loaded through load_nnx_state, served through
   InferenceEngine(batch_size=256) on requests of 256, 100 and 600 clouds;
   K1's launch count must equal the number of chunks, every logit must be
   finite, and the argmax must agree with the same model on the plain chain
   for >= 99% of clouds;
5. kernel (K5, dgcnn_encode_fused): against its plain version at B=32,
   N=1024, k=20, emb=512, on a ragged B=3, N=1000 cloud and on a lattice
   cloud whose 20th neighbors are decided by exact distance ties; times of
   the kernel, the plain version, an eager chain of cuBLAS bf16 matmuls,
   torch.topk and a gather (``library_ms``), and the bound;
6. kernel (K6, attention_pallas): against its plain version at the
   pointer's shape (B=32, H=4, N=M=1024, D=Dv=128), the head's (H=1,
   D=512, Dv=3), a ragged N=M=1000 and DCP(DGCNN(emb 1024))'s pointer
   (D=Dv=256: two 128-wide slabs of output columns), and the pointer's and
   head's shapes in f32 (f32 DCP's calls) and PRNet's pointer in f32 (B=16,
   768 queries against 1024 keys, and back; drawn from a generator of their
   own, so that the later phases see the data they saw before these cases
   were added), whose output must be f32, not rounded to bf16, within
   K6_F32_TOL of the plain version; the edges of the wgmma instance's tiles
   (N=37 against 200 keys, 768 against 1000, Dv=256 ragged, D=80 with
   Dv=8, two heads side by side whose second head's K and V are inf, where
   the first head must stay finite; from a third generator); times at the pointer's shape in bf16 and f32,
   the head's, Dv=256 and PRNet's, each beside its bound, the three-product
   floor of the exact max and the instance that ran, with
   scaled_dot_product_attention as ``library_ms`` (in f32 and at the head's
   shape with the first backend, in PyTorch's order, that takes it, named);
7. serve_dcp: DCP(DGCNN(512, k=20)) in bf16 eval with numpy-seeded weights
   loaded through load_nnx_state, served through
   InferenceEngine(batch_size=32) on 32, 10 and 70 (template, source)
   pairs (5 chunks); K5 must launch 2 and K6 7 times a chunk, every output
   must be finite, every est_R a rotation, and r and est_t must agree with
   the same model run on the plain versions;

8. kernel (K2, pointnet_pooled_int8) and serve_int8: the classifier
   quantized as bench.py does (quantize_pointnet_classifier on 64 clouds,
   make_fused_quant_forward); K2 bit for bit against its plain version at
   B=256, N=1024, on a ragged B=3, N=1000 cloud, at B=32 and on a random
   pack of emb 512 (the last two from a generator of their own), timed at
   B=256 and B=32, with the unfused int8 encoder (torch._int_mm) as
   ``library_ms``; served through InferenceEngine on the
   same requests as phase 4: K2 launched once a chunk, every logit finite,
   argmax agreement with the plain version >= 99%, agreement with the plain
   int8 forward and with the bf16 model reported;
9. kernel (K9, dgcnn_encode_fused_int8) and kernel (K10, attention_int8):
   DCP quantized as bench.py does (quantize_dcp on 8 + 8 clouds, int8_pv,
   fused_layers=False); K9 against its plain version on the full, ragged and
   lattice clouds, with an eager topk + torch._int_mm chain as
   ``library_ms``; K10 in both modes (int8 and bf16 P V) at the pointer's
   shape, a ragged N=M=1000 and the edges of its 128-key tiles (D=256 and
   512, N=37 against 200 keys, 768 against 768, 100 against 1000, two heads
   side by side, the second's keys all 127 and, in the hybrid mode through
   the C entry, its bf16 V inf; from a generator of their own), timed at the pointer's
   shape in both modes beside the bound, the three-product floor and the
   instance, with scaled_dot_product_attention on the dequantized q, k, v
   as ``library_ms``;
10. serve_dcp_int8: the int8 clone through InferenceEngine on the DCP
   requests: K9 launched 2, K10 6 and K6 1 times a chunk, every output
   finite, every est_R a rotation, r and est_t within DCP_TOL of the same
   clone on the plain versions;
11. kernel (K11a encoder_layer_int8, K11b decoder_layer_int8): the fused
   int8 pointer layers of quantize_dcp(..., fused_layers=True) in both P.V
   modes at the DCP shape (B=32, N=1024, d=512, 4 heads, ff 1024) and at
   N=512, on the encoder's features, against their plain versions with the
   JAX package's tie-flip profile (max |diff| < 0.08, under 1% of the
   elements above 2e-4), naming the attention instance that runs in each
   mode; the unfused int8 layer (QuantMHA + QuantFF on K10 and
   torch._int_mm) as ``library_ms``;
12. serve_dcp_int8_fused, serve_dcp_int8_hybrid_fused and
   serve_dcp_int8_hybrid_fused_approx: bench.py's fused int8 DCP
   configurations (int8 P.V; hybrid P.V; hybrid with DGCNN(approx_knn=True))
   through InferenceEngine on 5 requests (the int8 P.V clone) or 2 (the
   hybrid ones, whose plain versions are slow): K9 2, K11a 2, K11b 2, K6 1 and
   K10 (attention_int8) 0 launches a chunk, so that no layer took the module
   path; the DCP gates of phase 10; the approx phase also reports the share
   of (query, neighbor) picks that differ from exact kNN (information only);
   K5 and K9 with approx_knn=True against their plain versions first;
13. serve_template: TemplateRegistrar over the hybrid fused clone (bench.py's
   dcp_template_cached) on 2 requests: K9 1, K11a 2, K11b 2, K6 1, K10 0
   launches a chunk, and the DCP gates against the same model on the plain
   versions;
14. kernel (K3, pool_stats_pallas): against its plain version at the train
   step's shape (B=256, N=1024, K=128, E=1024) in bf16 and in f32 and on a
   ragged B=3, N=1000 cloud: max/min within TOL of the largest value, G and
   the column sum within POOL_SUM_TOL, z at the kernel's argmax/argmin
   within TOL of the plain max/min (the share of indices that differ is
   reported); times of the kernel, the plain version, an eager chain
   (torch.matmul materializing z, torch.max/min with indices, x^T x) as
   ``library_ms``, and the bound;
15. kernel (K4, pool_bwd_pallas): against its plain version with the
   indices of the K3 run (bf16 and f32, main shape; the ragged cloud) and
   with every channel on one point; dense dx_sp and dW_sel within
   POOL_SUM_TOL; index_add_ plus a gathered einsum as ``library_ms``;
   times and bounds in bf16 and in f32;
16. train: bench.py's training configuration (Classifier(PointNet(1024,
   use_bn=True)) in bf16, B=256, N=1024, Adam 1e-3, augmentation on) through
   Trainer.fit for one epoch of SyntheticModelNet40 (6 steps) in a temporary
   directory: K3 and K4 launched once a step, the epoch's loss finite, no
   step skipped, parameters and BN running statistics changed; one step on
   the kernels against the same step on their plain versions (same weights,
   batch and dropout generator) in bf16 and f32: loss, every gradient and
   the running statistics; the same two checks on the trained
   r4_pointnet_cls (the port checkpoint of phase 47) with the control
   k3_misplaced outside them, and beside each the plain step with K3's sums
   exact (reported); a save -> load round trip that restores the
   parameters and the optimizer state exactly; the step's forward, backward
   and optimizer times (CUDA events) and clouds/s;
17. kernel (K7, knn_neighbors_pallas): the edge features against the plain
   version, bit for bit (on clouds of distinct points, so the neighbor
   indices are the same too), at B=32, N=1024, k=20,
   on a lattice cloud (exact ties at the 20th neighbor), on a ragged B=3,
   N=1000 cloud and at k=40 (past K5's k <= 32); times of the kernel, the
   plain version, an eager chain of torch.cdist, torch.topk and a gather
   (``library_ms``), and the bound;
18. train_dcp: examples/train.py's DCP configuration (DCP(DGCNN(512, k=20))
   in f32, B=32, N=1024, Adam 1e-3) through Trainer.fit on
   RegistrationData("DCP", SyntheticModelNet40) for one epoch of
   TRAIN_DCP_STEPS steps and an eval pass (f32 DCP in eval mode): K7
   launched twice and K6 seven times a forward, K5 never; the loss finite,
   no step skipped, parameters and BN running statistics changed, the eval
   pass's rot_deg and trans finite; one step on the kernels against the same
   step on their plain versions (loss, every gradient, the running
   statistics); a save -> load round trip; the step's parts (CUDA events)
   and pairs/s;

19. kernel_k12 (_nn_oneway_pallas): K12 against its plain version, distances
   bit-equal and indices equal, at multistart's shape (B=256, N=M=1024),
   at detailed PCN's fine Chamfer (32 x 1024 points against 16,384, both
   directions), on a ragged pair and on lattice clouds with tied nearest
   points; times of the kernel, the plain version, torch.cdist + min
   (``library_ms``) and the bound;
20. kernel_k13 (_emd_fwd_pallas): K13 (one launch a call: a cluster of
   CTAs a cloud) against its plain version at PCN's coarse EMD (B=32,
   N=M=1024), at N > M and N < M, at B=1 (N=M=1024 and the gate's 4096:
   the largest resident clouds) and at ragged N and M: the cost to
   EMD_COST_TOL, g1 and g2 to a mean relative error below EMD_GRAD_TOL;
   times, the device launches a call (torch.profiler) and the bound (no
   PyTorch call computes approxmatch: ``library_ms`` null);
21. serve_ipcrnet: iPCRNet(PointNet(1024, use_bn=False)) in bf16 eval (8
   steps) with numpy-seeded weights through InferenceEngine(batch_size=32)
   on 32, 10 and 70 pairs: K1 nine times a chunk, every output finite,
   est_R a rotation to the bf16 rounding of its steps; then
   multistart_register with rotation_starts(8) at B=32: one forward at
   batch 256 (K1 nine times) and K12 twice; its result its best start's,
   the candidates rescored on K12's plain version bit for bit, and the
   one-step model against the plain versions (ipcrnet_agreement); pairs/s;
22. train_ipcrnet: examples/train.py's iPCRNet configuration in f32, B=20,
   N=1024, Adam 1e-3 through Trainer.fit on RegistrationData("iPCRNet",
   SyntheticModelNet40) for IPC_TRAIN_STEPS steps: K12 twice a step, K1
   never; loss finite, no step skipped, every weight changed, f32 est_R a
   rotation; one step against the plain versions (CHAMFER_STEP_TOL); the
   step's parts and pairs/s;
23. train_pcn: PCN(1024, num_coarse=1024) in f32, B=32, N=1024, coarse only,
   through Trainer.fit on ClassificationData(SyntheticModelNet40) for
   PCN_TRAIN_STEPS steps (K12 twice a step), then one step with
   detailed_output=True (K12 four times, the fine Chamfer against 16,384
   points), each against the plain versions; emd_loss_mean(points,
   coarse_output) forward and backward on K13 (one launch) against its
   plain version; the steps' parts and the EMD loss's time;
24. kernel_k8 (knn_pallas): against its plain version, indices equal and
   distances bit-equal, at PRNet's stage shapes (B=16; C = 3, 64, 128; the
   template's N=1024 and the source's N=768), a cross-cloud search (1024
   queries among 2048 points), a ragged one (777 among 1000, C=67), a
   lattice cloud with exact ties, near-duplicate features whose
   distances round below 0 and clouds of equal points (xyz and 64
   channels), where the picks must be 0 .. k-1; times of the kernel, the plain version,
   torch.cdist + torch.topk (``library_ms``) and the bound at each PRNet
   shape, and their sum over a forward's 16 launches;
25. serve_prnet: PRNet() (PRDGCNN(512, k=20), the transformer pointer, 512
   keypoints, 3 iterations) in f32 eval with numpy-seeded weights through
   InferenceEngine(batch_size=32) on 32, 10 and 70 (source, template)
   pairs: K8 16 and K6 18 launches a chunk, nothing else; every output
   finite, every est_R a rotation; one iteration on the kernels against the
   plain versions within PRNET_TOL, and the control k6_bf16_output (K6's
   output rounded to bf16) outside it; three iterations' gap and flipped
   neighbor and keypoint picks reported; multistart_register with 8 starts
   on 4 pairs (one forward at batch 32, K12 twice); pairs/s and model_ms;
26. train_prnet: PRNet() in f32, B=16, Adam 1e-3, through Trainer.fit on
   RegistrationData("PRNet", partial_source=True) over SyntheticModelNet40
   for PRNET_TRAIN_STEPS steps: K8 16 and K6 18 launches a step; the loss
   finite, no step skipped, weights and statistics changed; one step at one
   iteration against the plain versions (PRNET_STEP_TOL, with a control that
   must fail), the three-iteration step's gaps reported beside those of a
   one-ulp move of the source; a save -> load round trip; the step's parts,
   pairs/s and peak memory;
27. kernel_k14 (fps_pallas): against its plain version, indices equal, at
   FlowNet3D's six calls (sa1 and sa2 on each cloud of 16 SyntheticSceneflow
   pairs of N=2048, sa3 and sa4 on the first: 2048 -> 1024 -> 256 -> 64 ->
   16), a ragged cloud (1000 -> 777), every point picked (1024 -> 1024), a
   lattice with exact ties, random starts, the edges of the kernel's
   register tiles, past them (shared memory) and past shared memory (the
   scratch), 40 items and a cloud of equal points; times of the kernel, the
   plain version, the bound and the chain floor (the steps' reductions and
   barrier alone, ``fps_chain_floor``) at the four shapes and over a
   forward's six launches (no PyTorch call computes FPS: ``library_ms``
   null). Its data, and that of the phases below, come from generators of
   their own;
28. kernel_k15 (ball_query_pallas): against its plain version, indices
   equal, at FlowNet3D's six calls (the clouds and FPS samples of phase
   27), a ragged one, nsample = 128, a lattice whose neighbors lie on the
   radius and rows whose ball is empty (N everywhere), the int64 instance
   (query_ball_point's) equal to the int32 one; times, with
   torch.cdist + torch.where + torch.topk as ``library_ms``, and the bound
   from the points this run's queries read (printed at each shape);
29. serve_flownet: FlowNet3D() in f32 eval with numpy-seeded weights through
   InferenceEngine(batch_size=16) on 16, 5 and 40 SyntheticSceneflow pairs
   of N=2048: K14 6, K15 6 and K8 once a chunk, nothing else; the flow
   finite; K8 at three_nn's shape against its plain version and timed; the
   flow on the kernels against the plain versions within FLOW_TOL, and the
   control k15_nearest_first outside it; pairs/s and model_ms;
30. train_flownet: FlowNet3D() in f32, B=16, SGD (lr 1e-3, momentum 0.9) as
   examples/train_flownet.py, through Trainer.fit on
   FlowData(SyntheticSceneflow) for FLOW_TRAIN_STEPS steps: K14 6, K15 6 and
   K8 once a step; the loss finite, no step skipped, weights and statistics
   changed; one step against the plain versions (FLOW_STEP_TOL, the
   control must fail); a save -> load round trip; the step's parts,
   pairs/s and peak memory;
31. kernel_k16 (ball_group_pallas): against its plain version, values
   equal, at RPMNet's PPFNet grouping (the template clouds of 16
   RegistrationData("RPMNet") pairs with normals: 1024 queries among 1024
   points, r 0.3, nsample 64, C = 6), nsample 8 (outside the TPU gate), a
   ragged N = 1000 with 777 queries, centers outside the cloud, a lattice
   on the radius, and (from a generator of their own) N = 20,000 past one
   shared-memory chunk with the rows open across chunks and with the block
   stopping early, rows of nsample 200 x C 6 and 7, and of nsample 300 in
   balls of r 0.9 (the warp's 256-slot list full mid-scan); times, with
   torch.cdist + where + topk + gather as
   ``library_ms``, and the bound from the points this run's queries read.
   Its data, and that of the phases below, come from a generator of their
   own;
32. kernel_k17 (sinkhorn_log_pallas): against its plain version within
   K17_TOL at RPMNet's Sinkhorn (16, 1024, 1024, 5 iterations) on
   affinities of RPMNet's range, J != K, one iteration and a wide range;
   times and the bound (no single PyTorch call computes the slack
   Sinkhorn: ``library_ms`` null);
33. serve_rpmnet: RPMNet() in f32 eval with numpy-seeded weights through
   InferenceEngine(batch_size=16) on 16 and 5 pairs of N=1024 points with
   normals: K16 3 and K17 2 launches a chunk, nothing else; est_T,
   transformed_source and r finite, est_R a rotation; est_T,
   transformed_source and r on the kernels against the plain versions
   within RPM_TOL, and the control k17_bf16_output outside it; the bytes a
   request copies out, pairs/s and model_ms;
34. train_rpmnet: RPMNet() in f32, B=16, Adam 1e-3, through Trainer.fit on
   RegistrationData("RPMNet", SyntheticModelNet40(use_normals=True)) for
   RPM_TRAIN_STEPS steps: K16 3 and K17 2 launches a step (the backward
   recomputes through K17's plain version); the loss finite, no step
   skipped, every weight changed; one step against the plain versions
   (RPM_STEP_TOL, the control must fail); a save -> load round trip; the
   step's parts, pairs/s and peak memory;

35. serve_masknet_pnlk: the reference's test_masknet workflow (partial
   scans against full models, examples/evaluate.py's --masknet_ckpt):
   MaskNet(PointNet(1024, use_bn=True)) in bf16 eval through
   InferenceEngine(batch_size=32) filters the template of 32 and 10
   RegistrationData("PointNetLK", partial_source=True) pairs (a template of
   1024 points, a 768-point source), then PointNetLK(PointNet(1024,
   use_bn=True)) in f32 eval (10 iterations) registers the source against
   the masked template: K1 once a MaskNet chunk, nothing else (PointNetLK's
   f32 embeddings take the plain path, as in the JAX package); every output
   finite, est_R a rotation; MaskNet's mask on the kernels against the
   plain versions within LK_MASK_TOL (the picks' overlap reported) and the
   control k1_half_cloud outside it; PointNetLK on the same masked
   template, kernels against plain, within LK_SAME_TOL, and where the two
   runs' picks agree for a pair, the chain's est_T too; model times of
   MaskNet, of PointNetLK on the masked and on the full template, and
   pairs/s of the two engines in turn. Its data, and that of the phases
   below, come from a generator of its own and one cached set of clouds;
36. train_pnlk: PointNetLK(PointNet(1024, use_bn=True)) in f32, B=32,
   N=1024, 10 iterations, Adam 1e-3, task pointnetlk, through Trainer.fit
   for one step: K3 twice (the warm-up's template and source embeddings in
   train mode, forward only), K4 never; the loss finite, every weight and
   running statistic changed; the step against the plain versions
   (LK_STEP_TOL) and the control k3_last_tile_dropped outside it; the
   step's parts and pairs/s;
37. train_masknet: MaskNet(PointNet(1024, use_bn=True)) in f32, B=32, a
   template of 1024 and a source of 768 points, Adam 1e-3, the bce loss,
   for one step: K3 and K4 once each (the source's pool); the same checks
   against the plain versions (MASK_STEP_TOL) with the control
   k3_misplaced;
38. train_seg: Segmentation(PointNet(1024, use_bn=True, global_feat=False),
   40 classes) in f32, B=32, N=1024 on SyntheticPartSegmentation, Adam
   1e-3, for one step: no kernel launched (per-point features, in both
   packages); the loss finite, every weight and statistic changed; the
   step's parts;
39. kernel_pool_f32 (K3 and K4 in f32 at the shapes phases 36 and 37 give
   them: B=32, N=1024 and N=768, K=128, E=1024): K3 against its plain
   version within K3_F32_TOL (max/min, z at the kernel's indices) and
   K3_F32_SUM_TOL (G, the column sum), K4 with the kernel's indices within
   K4_F32_TOL (dx_sp, dW_sel); the controls k3_bf16_input and k4_bf16_input
   (the kernels fed their f32 operands rounded to bf16, as a kernel that
   computed its f32 path at bf16 precision would) outside them; the times
   of both kernels and their plain versions. Its data come from a generator
   of its own;
40. kernel_cls: K14, K8 and K15 at the shapes PointConv and CurveNet give
   them, on 32 SyntheticModelNet40 clouds of 1024 points and their FPS
   samples: FPS 1024 -> 512 -> 128 and 1024 -> 256 -> 64; kNN 21 of 1024
   (CurveNet's self search), 32 of 1024 for 512 queries and 64 of 512 for
   128 (PointConv's); ball queries of 20 members, 256 among 1024 (r 0.1)
   and 64 among 256 (r 0.2); each against its plain version, indices equal
   (K8's distances bit-equal), with times, plain and library times and
   bounds. K5 at the DGCNN classifier's emb 1024, B=32, N=1024 joins phase
   5. These phases draw from generators of their own;
41. serve_pointconv and train_pointconv: examples/train_pointconv.py's
   PointConvDensityClsSsg(classifier=True), 40 classes, f32, B=32, N=1024
   SyntheticModelNet40 clouds, numpy-seeded weights: one request through
   InferenceEngine (K14 2 and K8 2 launches, nothing else; logits finite),
   the logits on the kernels against the plain versions within
   CLS_SAME_TOL and the control k8_last_pick_repeated outside it; one Adam (1e-3)
   step through Trainer.fit (the same launches), held to the plain versions
   within CLS_STEP_TOL with the same control; model_ms, clouds/s, the
   step's parts;
42. serve_curvenet and train_curvenet: CurveNet() (k 20, the default
   curves), the same data: K8 once, K14 and K15 twice a forward (one kNN
   at 1024 points shared by LPFA and the four curve blocks there); the
   same checks with the control k15_nearest_first; the step is
   examples/train_curvenet.py's recipe (SGD 0.1, momentum 0.9, weight decay
   1e-4, cosine decay, label smoothing 0.2, augmentation);
43. serve_dgcnn_cls and train_dgcnn_cls: examples/train.py's dgcnn-cls,
   Classifier(DGCNN(1024, k=20)): bf16 eval serving on K5 (once a chunk),
   its logits within CLS_BF16_TOL of the plain versions' and the control
   k5_half_neighbours outside; an f32 Adam step on K7 (once), held within
   CLS_STEP_TOL with the control k7_kth_swapped;
44. serve_deepgmr and train_deepgmr: examples/train.py's DeepGMR(use_rri=True,
   nearest_neighbors=20) (d_model 1024, 16 clusters) in f32 with seeded
   weights, on 32 RegistrationData("DeepGMR") pairs of 1024
   SyntheticModelNet40 points (the family's clouds of phase 40), the RRI
   features computed in the forward: one request through InferenceEngine
   (no kernel launched, in either package), every output finite, est_R and
   est_R_inverse rotations within ROT_TOL; one Adam (1e-3) step through
   Trainer.fit on the deepgmr task with jittered sources (examples/train.py
   --noise: a clean source is its template moved, which the rotation-
   invariant features register exactly, so the loss would be rounding
   alone): the loss finite, every weight and statistic changed; model_ms,
   pairs/s, the step's parts. A generator of its own;
45. serve_masknet2 and train_masknet2: examples/test_masknet2.py's
   MaskNet2() in f32 with seeded weights and every attention gate beta
   drawn from N(0, 0.5) (at its initial 0 each attention is a dead
   branch), on 32 RegistrationData("DCP", partial_source=True) pairs as
   the masknet task draws them (a 1024-point template, a 768-point source,
   the template's ground-truth mask): one request (no kernel), both masks
   finite and in [0, 1]; one Adam (1e-3) step on the masknet task (bce):
   the loss finite, every weight and statistic changed; model_ms, pairs/s,
   the step's parts. A generator of its own;
46. cli_train: the port's entry points as a user runs them, in this
   process with --device cuda, into a temporary directory:
   ``examples.train`` with the r4_pointnet_cls recipe (--cosine --augment
   --label_smoothing 0.2 --export_feature) at the scripts' full width (emb
   1024, N=1024, B=32) for one epoch of --dataset_size 64 (two steps), then
   ``--model ipcrnet --task ipcrnet`` the same way, then ``examples.evaluate``
   on the iPCRNet checkpoint with --multistart 8; the checkpoints, the
   exported feature model and run.log written, every printed metric finite,
   and the launches the code implies: K3 and K4 once a classifier step (its
   f32 eval pass none), K12 twice an iPCRNet loss (steps and eval batches)
   and twice a multistart batch. Its weights come from the CLI's own seed;
47. cli_trained_cls: the trained classifier r4_pointnet_cls, converted from
   the JAX package's release into a port checkpoint
   (``learning3d_tpu_torch/trained``, tools/convert_release_torch.py),
   evaluated by ``examples.evaluate --quantize`` on the card on its 2048-cloud
   synthetic test set (f32 with no kernel, int8 through K2 once a batch),
   then served in bf16 through InferenceEngine(batch_size=256) (K1 once a
   chunk): the f32 argmax equal to the JAX package's stored argmax on every
   cloud whose JAX margin exceeds TRAINED_MARGIN, the int8 argmax agreeing
   with JAX's int8 on >= TRAINED_INT8_AGREE, the bf16 argmax with the port's
   f32 on >= AGREE; the control (two classes' logit rows swapped) fails each
   of the three. The card's accuracy, int8 accuracy and agreement are printed
   beside the JAX package's on the CPU and its manifest's TPU figures;
48. trained_rpmnet: the trained r4b_rpmnet (a port checkpoint, with the JAX
   package's CPU results on the first 16 pairs of its eval set) on those
   pairs, rebuilt by the port's RegistrationData("RPMNet") over
   SyntheticModelNet40(train=False, use_normals=True) (their igt the stored
   one): one forward at B=16, N=1024 launching K16 3 and K17 2 times; est_T
   on the kernels against the plain versions at one iteration within
   RPM_TOL and at two within RPM_TRAINED_TOL, against the JAX package's
   stored est_T pair by pair within RPM_JAX_TOL (the pair named in
   RPM_JAX_FLIPS within its own limit), the control k17_bf16_output outside
   each; phase 34's step check at one iteration on these weights and pairs
   (RPM_STEP_TOL; the weight network's gradients, which rounding decides at a
   trained minimum, set apart and measured) with the same control; and,
   reported, how far
   one ulp of the plain Sinkhorn's output moves est_T and the step at one and
   two iterations, and the two-iteration step on the kernels;
49. trained_flownet: the trained r4_flownet on the first 16 pairs of its
   eval set (SyntheticSceneflow at the release's 1024 points, the flow's
   ground truth the stored one): one forward launching K14 6, K15 6 and K8
   once; the flow against the plain versions within FLOW_TOL and against the
   JAX package's stored flow within FLOW_JAX_TOL, the control
   k15_nearest_first outside both; EPE and Acc3D beside JAX's on the CPU;

then the ``kernels`` line and, last, ``{"ok": true, "device": ...}``. Any
failed check raises, so the script exits non-zero and prints no result. It
needs a CUDA card and the repository's checkout around it; the
checkpoints it reads are the port's own under ``learning3d_tpu_torch/trained``,
and it writes into the kernels' build directory and temporary directories.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import importlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

T0 = time.perf_counter()
SEED = 0
B, N, EMB, CLASSES = 256, 1024, 1024, 40
K1_SMALL_B = 32  # iPCRNet's serving chunk: K1 also timed there
REQUESTS = (256, 100, 600)
TOL = 2e-2  # max |kernel - plain| <= TOL * max |plain|: same bf16 operands, other sum order
# K6 on f32 q, k, v writes f32: only the sum order differs from the plain
# version (a probability now and then rounds to the neighbouring bf16
# value): 4.5e-4 and 5.9e-4 of max at the pointer's and head's shapes on
# the H100. An output rounded to bf16 moves each value by up to 2^-9 of
# it; the check also rejects it outright (an f32 output is not all bf16
# values)
K6_F32_TOL = 1e-3
AGREE = 0.99
DCP_B, DCP_N, DCP_EMB, DCP_K = 32, 1024, 512, 20
DCP_REQUESTS = (32, 10, 70)
FUSED_REQUESTS = (32, 10, 70, 32, 20)  # 5 requests, 7 chunks of 32
# the hybrid P.V clones' plain versions take ~0.8 s a chunk (K11's plain
# hybrid chain): they serve the first two of FUSED_REQUESTS, a full chunk
# and a ragged one
HYBRID_SERVED = 2
# r and est_t of the kernel path against the plain path, max |k - p| <=
# DCP_TOL * max |p|: an f32 sum in another order can round an activation
# to the neighbouring bf16 value (2^-8 of it), and the encoder, the pointer
# and the head carry such steps on; a kernel that computed something else
# would be off by the order of the values themselves.
DCP_TOL = 5e-2
ROT_TOL = 1e-3  # max |R R^T - I| and |det R - 1| of every est_R
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core peak
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores, an FMA counted as two flops
# H100 SXM: one f32 instruction a lane and clock, 128 lanes on each of 132
# SMs at 1.98 GHz; the rate of counts of instructions (a difference, a
# product, a sum, a comparison: each one instruction)
PEAK_F32_OPS = 132 * 128 * 1.98e9
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SFU_EXP_PER_S = 16 * 132 * 1.98e9  # H100 SXM: 16 exponentials a clock on each of 132 SMs at 1.98 GHz
CALIB_CLOUDS, DCP_CALIB_PAIRS = 64, 8  # bench.py's calibration batches
K_TAIL = 128  # the input width of PointNet's fused last stage (conv5)
# G and the column sum are sums over all B*N = 262,144 rows: the kernel sums
# per cloud and then over the clouds, the plain version in cuBLAS's order
# (and for f32 the kernel's hi/lo bf16 split is about 2^-16 of a product)
POOL_SUM_TOL = 1e-4
TRAIN_STEPS, TRAIN_LR = 6, 1e-3
# one train step on the kernels against the same step on the plain
# versions, per-tensor relative error: in bf16 an f32 sum in another order
# can move an activation to the neighbouring bf16 value (2^-8) and the
# head's BatchNorm, the log-softmax and the backward carry it on. In f32,
# K3 multiplies through a bf16 hi/lo split (about 2^-16 of a product, as the
# TPU kernel does) where the plain version multiplies in f32, so a channel
# whose two largest values lie that close picks another critical point
# (1e-5 of the picks in phase 14); each such pick moves that channel's
# gradient to another point, some 0.5% of an encoder gradient's norm
STEP_TOL = {"bf16": 3e-2, "f32": 2e-2}
# biases whose exact gradient is 0: those of the Linears that feed a
# train-mode BatchNorm (the batch mean takes them out), and the last encoder
# BatchNorm's (it shifts every cloud's pooled feature alike, which the
# head's train-mode bn1 takes out again while the ReLU passes every cloud).
# What is computed is rounding noise (in bf16 a few % of the layer's weight
# gradient, in the JAX package's bf16 step as in the port's): it is held to
# NOISE_TOL of the layer's weight gradient instead
ZERO_GRADIENT_BIASES = tuple(f"feature_model.convs.{i}.bias" for i in range(5)) + (
    "feature_model.bns.4.bias", "linear1.bias", "linear2.bias")
NOISE_TOL = 5e-2
TRAIN_DCP_STEPS = 4
# one DCP train step on K7 and K6 against the same step on their plain
# versions, per-tensor relative error. K7 is exact (the same neighbors, the
# coordinates copied), and both steps take the attention's backward through
# the oracle. K6 and its plain version round the same bf16 operands and P
# and both write f32, but sum in another order, so a probability can round
# to the neighbouring bf16 value (2^-8 of it); the soft correspondences
# carry that through the Kabsch solver and the backward into every
# gradient: 6.1e-4 to 2.6e-3 on the H100 over this phase's weights and
# those of tools/torch_dcp_step_gaps.py. K6's output rounded to bf16 (the
# control, k6_bf16_output) gives 5.3e-3 to 1.7e-2 there, and must fail
DCP_STEP_TOL = 4e-3
# the key projections' biases have no gradient in exact arithmetic (a bias
# on every key shifts a query's scores by one constant, which the softmax
# takes out): what is computed is rounding noise, held to DCP_NOISE_TOL of
# the projection's weight gradient
DCP_ZERO_GRADIENT_BIASES = tuple(f"pointer.{layer}.{attn}.wk.bias" for layer, attn in (
    ("enc_layers.0", "self_attn"), ("dec_layers.0", "self_attn"), ("dec_layers.0", "cross_attn")))
DCP_NOISE_TOL = 1e-3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "t": round(time.perf_counter() - T0, 3), **fields}), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def check_close(got, want, what: str, tol: float = TOL) -> tuple[float, float]:
    """(max abs error, that over max |want|); raises past ``tol``."""
    got, want = got.float(), want.float()
    require(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), f"{what}: output finite")
    abs_err = (got - want).abs().max().item()
    rel_err = abs_err / max(want.abs().max().item(), 1e-30)
    require(rel_err <= tol, f"{what}: rel err {rel_err} > {tol}")
    return abs_err, rel_err


def bound(flops: float, nbytes: float, *, int8_ops: float = 0.0, f32_flops: float = 0.0,
          f32_ops: float = 0.0) -> tuple[float, str]:
    """Least time (ms) and what sets it: the operations or the bytes over the
    memory rate. The tensor cores run the bf16 ``flops`` and the
    ``int8_ops`` one after the other, each type at its peak; the CUDA cores
    run beside them the ``f32_flops`` (counts that credit an FMA as two
    flops, at PEAK_F32_FLOPS) and the ``f32_ops`` (counts of f32
    instructions, at PEAK_F32_OPS), so the operations take the longer of the
    two."""
    cuda_s = f32_flops / PEAK_F32_FLOPS + f32_ops / PEAK_F32_OPS
    ops_s = max(flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS, cuda_s)
    bytes_s = nbytes / PEAK_BYTES
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def random_nnx_state(rng, emb: int, num_classes: int) -> dict:
    """A flat nnx state of Classifier(PointNet(emb, use_bn=True)) with
    numpy-seeded weights and non-trivial BatchNorm statistics."""
    flat = {}

    def linear(prefix, i, o):
        flat[f"{prefix}.kernel"] = rng.normal(0.0, i**-0.5, (i, o)).astype(np.float32)
        flat[f"{prefix}.bias"] = rng.normal(0.0, 0.1, (o,)).astype(np.float32)

    def bn(prefix, c):
        flat[f"{prefix}.scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        flat[f"{prefix}.bias"] = rng.normal(0.0, 0.1, c).astype(np.float32)
        flat[f"{prefix}.mean"] = rng.normal(0.0, 0.2, c).astype(np.float32)
        flat[f"{prefix}.var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)

    dims = [3, 64, 64, 64, 128, emb]
    for k, (i, o) in enumerate(zip(dims[:-1], dims[1:])):
        linear(f"feature_model.convs.{k}", i, o)
        bn(f"feature_model.bns.{k}", o)
    linear("linear1", emb, 512)
    bn("bn1", 512)
    linear("linear2", 512, 256)
    bn("bn2", 256)
    linear("linear3", 256, num_classes)
    return flat


def cuda_ms(fn, reps: int = 20, warmup: int = 3, runs: int = 3) -> float:
    """Time of one call: CUDA events around ``reps`` back-to-back calls,
    divided by ``reps``; the median of ``runs`` such runs, after warm-up.
    Back to back, the host enqueues the next call while the card runs this
    one, so a call's host overhead shows only where it exceeds its device
    time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def library_chain(x, ws, bs):
    """Yardstick only, never used by the port: the unfused eager chain of
    bf16 torch.matmul (cuBLAS) calls, bias, ReLU and max over points."""
    h = x.to(torch.bfloat16)
    for w, b in zip(ws[:-1], bs[:-1]):
        h = torch.relu(torch.matmul(h, w.to(torch.bfloat16)) + b.to(torch.bfloat16))
    z = torch.matmul(h, ws[-1].to(torch.bfloat16)) + bs[-1].to(torch.bfloat16)
    return torch.relu(torch.amax(z, dim=-2))


def k1_bound(batch: int, n_pts: int, ws, bs) -> tuple[float, str]:
    """K1's bound: its operations, and its bytes (x read once, weights and
    biases read once as f32, output written once as bf16)."""
    macs = sum(w.shape[0] * w.shape[1] for w in ws)
    nbytes = 4 * batch * n_pts * 3 + 4 * (macs + sum(b.numel() for b in bs)) + 2 * batch * ws[-1].shape[1]
    return bound(2.0 * batch * n_pts * macs, nbytes)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, torch_name=kind, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())
    return kind


def phase_build() -> None:
    from learning3d_tpu_torch.kernels import _build

    shutil.rmtree(_build.BUILD_ROOT / _build.source_hash(), ignore_errors=True)
    t0 = time.perf_counter()
    lib = _build.build()
    seconds = time.perf_counter() - t0
    _build.library()
    log = (lib.parent / "build.log").read_text().splitlines()
    ptxas = [line.strip() for line in log if "registers" in line or "spill" in line]
    emit("build", seconds=round(seconds, 3), sources=[p.name for p in _build.sources()], ptxas=ptxas)


def folded_chain(model):
    """The BN-folded (weights, biases) of the model's PointNet chain."""
    from learning3d_tpu_torch.kernels.pointnet_fused import fold_conv_bn

    pn = model.feature_model
    with torch.inference_mode():
        folded = [fold_conv_bn(c, bn) for c, bn in zip(pn.convs, pn.bns)]
    return [w for w, _ in folded], [b for _, b in folded]


def phase_kernel(model, rng) -> dict:
    from learning3d_tpu_torch.kernels.pointnet_fused import oracle_chain, pointnet_pooled_kernel

    ws, bs = folded_chain(model)
    errs = {}
    for name, shape in (("full", (B, N, 3)), ("ragged", (3, 1000, 3))):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
        with torch.inference_mode():
            got = pointnet_pooled_kernel(x, ws, bs)
            want = oracle_chain(x, ws, bs)
        torch.cuda.synchronize()
        require(got.shape == (shape[0], EMB), f"K1 output shape {name}")
        errs[name] = check_close(got, want, f"K1 vs plain ({name})")
        if name == "full":
            x_full = x
    # iPCRNet's serving chunk, B=32, from a generator of its own so that
    # the later phases keep their data
    x32 = torch.from_numpy(np.random.default_rng(SEED + 16).normal(size=(K1_SMALL_B, N, 3))
                           .astype(np.float32)).cuda()
    with torch.inference_mode():
        got, want = pointnet_pooled_kernel(x32, ws, bs), oracle_chain(x32, ws, bs)
        torch.cuda.synchronize()
        errs[f"B{K1_SMALL_B}"] = check_close(got, want, f"K1 vs plain (B={K1_SMALL_B})")
        k_ms = cuda_ms(lambda: pointnet_pooled_kernel(x_full, ws, bs))
        p_ms = cuda_ms(lambda: oracle_chain(x_full, ws, bs))
        l_ms = cuda_ms(lambda: library_chain(x_full, ws, bs))
        small = {"kernel_ms": cuda_ms(lambda: pointnet_pooled_kernel(x32, ws, bs)),
                 "plain_ms": cuda_ms(lambda: oracle_chain(x32, ws, bs)),
                 "library_ms": cuda_ms(lambda: library_chain(x32, ws, bs))}
    bound, bound_by = k1_bound(B, N, ws, bs)
    small["bound_ms"], small["bound_by"] = k1_bound(K1_SMALL_B, N, ws, bs)
    result = {
        "max_abs_err": max(a for a, _ in errs.values()),
        "max_rel_err": max(r for _, r in errs.values()),
        "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
        "bound_ms": bound, "bound_by": bound_by,
    }
    emit("kernel", name="pointnet_pooled_kernel", tolerance=f"max|k-p| <= {TOL}*max|p|",
         errors={k: {"abs": a, "rel": r} for k, (a, r) in errs.items()},
         library="eager bf16 torch.matmul chain (cuBLAS), yardstick only", **result,
         **{f"B{K1_SMALL_B}": small})
    return result


def phase_serve(model, rng) -> int:
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.kernels.pointnet_fused import oracle_chain
    from learning3d_tpu_torch.serve import InferenceEngine

    engine = InferenceEngine(model, batch_size=B)
    requests = [rng.normal(size=(n, N, 3)).astype(np.float32) for n in REQUESTS]
    chunks = sum(-(-n // B) for n in REQUESTS)
    reset_launches()
    outs = [engine(x) for x in requests]
    torch.cuda.synchronize()
    launches = LAUNCHES["pointnet_pooled_kernel"]
    require(launches == chunks, f"K1 launched {launches} times for {chunks} chunks")
    for x, out in zip(requests, outs):
        require(out.shape == (x.shape[0], CLASSES), f"logits shape {out.shape}")
        require(bool(np.isfinite(out).all()), "every logit finite")

    ws, bs = folded_chain(model)
    agree = total = 0
    with torch.inference_mode():
        for x, out in zip(requests, outs):
            plain = model.head(oracle_chain(torch.from_numpy(x).cuda(), ws, bs)).float().cpu().numpy()
            agree += int((plain.argmax(-1) == out.argmax(-1)).sum())
            total += x.shape[0]
    require(agree / total >= AGREE, f"argmax agreement {agree}/{total} < {AGREE}")

    x256 = requests[0]
    engine(x256)
    reps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine(x256)
    host_s = (time.perf_counter() - t0) / reps
    x_dev = torch.from_numpy(x256).cuda()
    with torch.inference_mode():
        model_ms = cuda_ms(lambda: model(x_dev))
    emit("serve", requests=list(REQUESTS), chunks=chunks, launches=launches,
         argmax_agree=agree / total, clouds_per_s=B / host_s, engine_ms=1e3 * host_s,
         model_ms=model_ms, model_clouds_per_s=B / (model_ms * 1e-3))
    return launches


def random_dcp_state(rng, emb: int, ff: int = 1024) -> dict:
    """A flat nnx state of DCP(DGCNN(emb)) with the transformer pointer, with
    numpy-seeded weights and non-trivial BatchNorm statistics."""
    flat = {}

    def linear(prefix, i, o, bias=True):
        flat[f"{prefix}.kernel"] = rng.normal(0.0, i**-0.5, (i, o)).astype(np.float32)
        if bias:
            flat[f"{prefix}.bias"] = rng.normal(0.0, 0.1, (o,)).astype(np.float32)

    def bn(prefix, c):
        flat[f"{prefix}.scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        flat[f"{prefix}.bias"] = rng.normal(0.0, 0.1, c).astype(np.float32)
        flat[f"{prefix}.mean"] = rng.normal(0.0, 0.2, c).astype(np.float32)
        flat[f"{prefix}.var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)

    def norm(prefix, c):
        flat[f"{prefix}.a"] = rng.normal(1.0, 0.1, c).astype(np.float32)
        flat[f"{prefix}.b"] = rng.normal(0.0, 0.1, c).astype(np.float32)

    def attn(prefix):
        for w in ("wq", "wk", "wv", "wo"):
            linear(f"{prefix}.{w}", emb, emb)

    for k, (i, o) in enumerate([(6, 64), (64, 64), (64, 128), (128, 256), (512, emb)]):
        linear(f"emb_nn.convs.{k}", i, o, bias=False)
        bn(f"emb_nn.bns.{k}", o)
    enc, dec = "pointer.enc_layers.0", "pointer.dec_layers.0"
    attn(f"{enc}.self_attn")
    attn(f"{dec}.self_attn")
    attn(f"{dec}.cross_attn")
    for layer in (enc, dec):
        linear(f"{layer}.ff.w1", emb, ff)
        linear(f"{layer}.ff.w2", ff, emb)
    for name in (f"{enc}.norm1", f"{enc}.norm2", f"{dec}.norm1", f"{dec}.norm2", f"{dec}.norm3",
                 "pointer.enc_norm", "pointer.dec_norm"):
        norm(name, emb)
    return flat
def lattice_cloud(rng, batch: int, n_pts: int) -> np.ndarray:
    """Points of a 10 x 10 x 10 integer lattice scaled by 0.25 (every
    coordinate and squared distance exact in f32) in a random order. An
    inner point has 1 + 6 + 12 neighbors within distance^2 2/16 and 8 at
    3/16, so exact ties decide its 20th neighbor."""
    grid = np.stack(np.meshgrid(*[np.arange(10)] * 3, indexing="ij"), -1).reshape(-1, 3)
    return np.stack([0.25 * grid[rng.permutation(len(grid))[:n_pts]] for _ in range(batch)]).astype(np.float32)


def library_dgcnn(x, ws, bs, k):
    """Yardstick only, never used by the port: the eager encoder as cuBLAS
    bf16 matmuls, torch.topk over matmul-expanded distances and a gather."""
    bf = torch.bfloat16
    sq = (x * x).sum(-1)
    d = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.bmm(x, x.transpose(1, 2))
    idx = torch.topk(d, k, dim=-1, largest=False).indices
    xb = x.to(bf)
    xw1, c1 = xb @ ws[0][:3].to(bf), xb @ ws[0][3:].to(bf) + bs[0].to(bf)
    B, N, C = xw1.shape
    nbr = torch.gather(xw1, 1, idx.reshape(B, -1, 1).expand(-1, -1, C)).reshape(B, N, k, C)
    e = torch.relu(nbr + c1[:, :, None])
    pooled = [e.amax(2)]
    for w, b in zip(ws[1:4], bs[1:4]):
        e = torch.relu(e @ w.to(bf) + b.to(bf))
        pooled.append(e.amax(2))
    return torch.relu(torch.cat(pooled, -1) @ ws[4].to(bf) + bs[4].to(bf))


def folded_dgcnn(model):
    """The BN-folded (weights, biases) of the model's DGCNN encoder."""
    from learning3d_tpu_torch.kernels.dgcnn_fused import fold_bn

    enc = model.emb_nn
    with torch.inference_mode():
        folded = [fold_bn(c, bn) for c, bn in zip(enc.convs, enc.bns)]
    return [w for w, _ in folded], [b for _, b in folded]


def k5_bound(ws, bs, batch, n_pts, k, emb) -> tuple[float, str]:
    """K5's bound: its products (a point's k edges through stages 1-4, the
    last stage, the first stage's two halves), and its bytes (the cloud,
    the weights as f32, the bf16 output)."""
    macs = k * (64 * 64 + 64 * 128 + 128 * 256) + 512 * emb + 2 * 3 * 64  # a point
    nbytes = 4 * batch * n_pts * 3 + 4 * sum(w.numel() + b.numel() for w, b in zip(ws, bs)) + 2 * batch * n_pts * emb
    return bound(2.0 * batch * n_pts * macs, nbytes)


def phase_kernel_k5(model, rng, wide) -> dict:
    """K5 at DCP's encoder (emb 512) on the full, ragged and lattice clouds,
    and at the DGCNN classifier's (``wide``: emb 1024, B=32, N=1024, from a
    generator of its own), against the plain version; times at both."""
    from learning3d_tpu_torch.kernels.dgcnn_fused import (
        DGCNNBf16Weights, dgcnn_encode_kernel, dgcnn_encode_packed, dgcnn_encode_reference)

    ws, bs = folded_dgcnn(model)
    cases = {
        "full": rng.normal(size=(DCP_B, DCP_N, 3)).astype(np.float32),
        "ragged": rng.normal(size=(3, 1000, 3)).astype(np.float32),
        "ties": lattice_cloud(rng, 2, 1000),
    }
    errs = {}
    with torch.inference_mode():
        for name, x_np in cases.items():
            x = torch.from_numpy(x_np).cuda()
            got = dgcnn_encode_kernel(x, ws, bs, DCP_K)
            want = dgcnn_encode_reference(x, ws, bs, DCP_K)
            torch.cuda.synchronize()
            errs[name] = check_close(got, want, f"K5 vs plain ({name})")
        x = torch.from_numpy(cases["full"]).cuda()
        pack = DGCNNBf16Weights(ws, bs)  # the model's pack, built once
        k_ms = cuda_ms(lambda: dgcnn_encode_packed(x, pack, DCP_K))
        p_ms = cuda_ms(lambda: dgcnn_encode_reference(x, ws, bs, DCP_K), reps=3, warmup=1)
        l_ms = cuda_ms(lambda: library_dgcnn(x, ws, bs, DCP_K))
        wws, wbs = [w for w, _ in wide], [b for _, b in wide]
        xw = torch.from_numpy(np.random.default_rng([SEED, 17]).normal(size=(CLS_B, CLS_N, 3))
                              .astype(np.float32)).cuda()
        got, want = dgcnn_encode_kernel(xw, wws, wbs, DGCNN_CLS_K), dgcnn_encode_reference(xw, wws, wbs, DGCNN_CLS_K)
        torch.cuda.synchronize()
        errs["emb1024"] = check_close(got, want, "K5 vs plain (emb 1024, B=32)")
        wpack = DGCNNBf16Weights(wws, wbs)
        emb1024 = {"kernel_ms": cuda_ms(lambda: dgcnn_encode_packed(xw, wpack, DGCNN_CLS_K)),
                   "plain_ms": cuda_ms(lambda: dgcnn_encode_reference(xw, wws, wbs, DGCNN_CLS_K), reps=1, runs=1),
                   "library_ms": cuda_ms(lambda: library_dgcnn(xw, wws, wbs, DGCNN_CLS_K))}
    bound_ms, bound_by = k5_bound(ws, bs, DCP_B, DCP_N, DCP_K, DCP_EMB)
    emb1024["bound_ms"], emb1024["bound_by"] = k5_bound(wws, wbs, CLS_B, CLS_N, DGCNN_CLS_K, DGCNN_CLS_EMB)
    result = {
        "max_abs_err": max(a for a, _ in errs.values()),
        "max_rel_err": max(r for _, r in errs.values()),
        "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    emit("kernel", name="dgcnn_encode_fused", tolerance=f"max|k-p| <= {TOL}*max|p|",
         shape={"B": DCP_B, "N": DCP_N, "k": DCP_K, "emb": DCP_EMB},
         errors={k: {"abs": a, "rel": r} for k, (a, r) in errs.items()},
         library="eager cuBLAS bf16 matmuls + torch.topk + gather, yardstick only", **result,
         emb1024={"B": CLS_B, "N": CLS_N, "k": DGCNN_CLS_K, **emb1024})
    return result


def attention_bound(q, k, v) -> tuple[float, str]:
    B, H, N, D = q.shape
    M, Dv = v.shape[2], v.shape[3]
    flops = 2.0 * B * H * N * M * (D + Dv)
    nbytes = 2 * B * H * (N * D + M * D + M * Dv + N * Dv)
    return bound(flops, nbytes)


def attention_floor3(q, k, v) -> float:
    """K6's least time with the exact max (ms): the two passes' three
    products, Q K^T twice and P V once, at the dense bf16 peak."""
    B, H, N, D = q.shape
    M, Dv = v.shape[2], v.shape[3]
    return 1e3 * 2.0 * B * H * N * M * (2 * D + Dv) / PEAK_BF16_FLOPS


def sdpa_library_ms(q, k, v) -> tuple[float, str]:
    """SDPA on q, k, v with the first backend, in PyTorch's order of
    preference, that takes them (the head's D=512, Dv=3, f32); its time and
    name."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                sdpa(q, k, v)
                torch.cuda.synchronize()
                return cuda_ms(lambda: sdpa(q, k, v)), f"scaled_dot_product_attention ({backend.name})"
        except RuntimeError:
            continue
    raise RuntimeError(f"no SDPA backend takes q {tuple(q.shape)} {q.dtype}, v {tuple(v.shape)}")


def k6_instance(q, v) -> str:
    """The instance of K6 (attention.cu) that runs q, v's shapes."""
    from learning3d_tpu_torch.kernels import _build

    return _build.library().attention_bf16_instance(q.shape[-1], v.shape[-1]).decode()


def side_by_side_heads(q, k, v, big):
    """q, k, v with the second head's keys all ``big``: a kernel that read
    them for the first head's keys past M would move its softmax."""
    k = k.clone()
    k[:, 1] = big
    return q, k, v


def inf_second_head(q, k, v):
    """q, k, v with the second head's K and V all inf (see
    ``check_first_head``)."""
    k, v = k.clone(), v.clone()
    k[:, 1] = v[:, 1] = float("inf")
    return q, k, v


def check_first_head(got, want, what: str, tol: float = TOL) -> tuple[float, float]:
    """Two heads side by side whose second head's K and V are inf: the
    first head within ``tol`` of its plain version and finite (a kernel that
    read the second head's rows for the first head's keys past M would give
    0 * inf = NaN there, though the mask makes their p exactly 0), the
    second head not finite (its inputs did reach the kernel)."""
    require(not bool(torch.isfinite(got[:, 1].float()).all()), f"{what}: the second head's inf reached it")
    return check_close(got[:, :1], want[:, :1], f"{what}, first head", tol)


# K10's one instance (csrc/attention_int8.cu), with its ring depth at D = 128
K10_INSTANCE = "wgmma+TMA, 128-key tiles, 3 K + 2 V stages"


def k10_hybrid_bf16_v(q, k, v16, s_q, s_k, s_v):
    """K10's hybrid mode through its C entry on a bf16 V that the caller
    made, so that V may hold what no int8 V widens to (inf). The wrapper
    widens its int8 V to this layout, (B*H, M, D) bf16, first."""
    from learning3d_tpu_torch.kernels import _build

    B, H, N, D = q.shape
    M = k.shape[2]
    q, k, v16 = (t.contiguous() for t in (q, k, v16))
    out = torch.empty((B, H, N, D), device=q.device, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    err = _build.library().attention_int8(q.data_ptr(), k.data_ptr(), v16.data_ptr(), out.data_ptr(), B * H, N, M,
                                          M, D, ctypes.c_float(s_q * s_k / D**0.5), ctypes.c_float(s_v), 0, stream)
    _build.check(err, "attention_int8")
    return out


def phase_kernel_k6(rng) -> dict:
    from learning3d_tpu_torch.kernels.attention import attention_pallas, attention_reference

    def qkv(b, h, n, m, d, dv, dtype=torch.bfloat16, gen=rng):
        return [torch.from_numpy(gen.normal(size=shape).astype(np.float32)).cuda().to(dtype)
                for shape in ((b, h, n, d), (b, h, m, d), (b, h, m, dv))]

    prnet_rng = np.random.default_rng([SEED, 6])  # cases added later draw apart from the shared stream
    edge_rng = np.random.default_rng([SEED, 14])

    cases = {
        "pointer": qkv(DCP_B, 4, DCP_N, DCP_N, 128, 128),
        "head": qkv(DCP_B, 1, DCP_N, DCP_N, DCP_EMB, 3),
        "ragged": qkv(4, 4, 1000, 1000, 128, 128),
        "dv256": qkv(DCP_B, 4, DCP_N, DCP_N, 256, 256),
        # f32 DCP's calls (training, its eval pass, f32 serving)
        "pointer_f32": qkv(DCP_B, 4, DCP_N, DCP_N, 128, 128, torch.float32),
        "head_f32": qkv(DCP_B, 1, DCP_N, DCP_N, DCP_EMB, 3, torch.float32),
        # PRNet's pointer in f32: the 768-point source against the
        # 1024-point template, and back
        "prnet_f32": qkv(PRNET_TRAIN_B, 4, PRNET_NS, PRNET_NT, 128, 128, torch.float32, prnet_rng),
        "prnet_back_f32": qkv(PRNET_TRAIN_B, 4, PRNET_NT, PRNET_NS, 128, 128, torch.float32, prnet_rng),
        # the edges of the wgmma instance's 128-row blocks and 128-key
        # tiles: N below 64, key counts no multiple of the tile, Dv = 256
        # ragged, a partial 64-column box of D with one narrow slab, and two
        # heads side by side whose second head's K and V are inf
        "n37_m200": qkv(1, 2, 37, 200, 128, 128, gen=edge_rng),
        "n768_m1000": qkv(1, 2, 768, 1000, 128, 128, gen=edge_rng),
        "dv256_ragged": qkv(1, 2, 300, 1000, 256, 256, gen=edge_rng),
        "d80_dv8": qkv(1, 2, 130, 70, 80, 8, gen=edge_rng),
        "heads_side_by_side": inf_second_head(*qkv(1, 2, 100, 200, 128, 128, gen=edge_rng)),
    }
    errs, times = {}, {}
    with torch.inference_mode():
        for name, (q, k, v) in cases.items():
            got = attention_pallas(q, k, v)
            want = attention_reference(q, k, v)
            torch.cuda.synchronize()
            require(got.dtype == q.dtype, f"K6 ({name}): output {got.dtype} for q {q.dtype}")
            if q.dtype == torch.float32:
                require(bool((got != got.to(torch.bfloat16).float()).any()), f"K6 ({name}): output rounded to bf16")
            tol = K6_F32_TOL if q.dtype == torch.float32 else TOL
            if name == "heads_side_by_side":
                errs[name] = check_first_head(got, want, f"K6 vs plain ({name})", tol)
                continue
            errs[name] = check_close(got, want, f"K6 vs plain ({name})", tol)
        for name in ("pointer", "pointer_f32", "head", "dv256", "prnet_f32", "prnet_back_f32"):
            q, k, v = cases[name]
            times[name] = {
                "kernel_ms": cuda_ms(lambda: attention_pallas(q, k, v)),
                "plain_ms": cuda_ms(lambda: attention_reference(q, k, v), reps=1, warmup=1, runs=1),
                "bound_ms": attention_bound(q, k, v)[0], "floor3_ms": attention_floor3(q, k, v),
                "instance": k6_instance(q, v),
            }
        q, k, v = cases["pointer"]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        l_ms = cuda_ms(lambda: sdpa(q, k, v))
        times["pointer"]["library_ms"] = l_ms
        times["dv256"]["library_ms"] = cuda_ms(lambda: sdpa(*cases["dv256"]))
        for name in ("pointer_f32", "head", "prnet_f32", "prnet_back_f32"):
            times[name]["library_ms"], times[name]["library"] = sdpa_library_ms(*cases[name])
    bound_ms, bound_by = attention_bound(*cases["pointer"])
    result = {
        "max_abs_err": max(a for a, _ in errs.values()),
        "max_rel_err": max(r for _, r in errs.values()),
        "kernel_ms": times["pointer"]["kernel_ms"], "plain_ms": times["pointer"]["plain_ms"],
        "library_ms": l_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }
    emit("kernel", name="attention_pallas",
         tolerance=f"max|k-p| <= {TOL}*max|p| in bf16, {K6_F32_TOL}*max|p| in f32 (an f32 output)",
         shapes={"pointer": [DCP_B, 4, DCP_N, DCP_N, 128, 128], "head": [DCP_B, 1, DCP_N, DCP_N, DCP_EMB, 3],
                 "dv256": [DCP_B, 4, DCP_N, DCP_N, 256, 256], "pointer_f32": "pointer in f32",
                 "head_f32": "head in f32", "prnet_f32": [PRNET_TRAIN_B, 4, PRNET_NS, PRNET_NT, 128, 128],
                 "prnet_back_f32": [PRNET_TRAIN_B, 4, PRNET_NT, PRNET_NS, 128, 128],
                 "n37_m200": [1, 2, 37, 200, 128, 128], "n768_m1000": [1, 2, 768, 1000, 128, 128],
                 "dv256_ragged": [1, 2, 300, 1000, 256, 256], "d80_dv8": [1, 2, 130, 70, 80, 8],
                 "heads_side_by_side": [1, 2, 100, 200, 128, 128]},
         errors={k: {"abs": a, "rel": r} for k, (a, r) in errs.items()}, times=times,
         library="torch scaled_dot_product_attention (default backends in bf16, the first that takes f32 or the "
                 "head's shape), yardstick only", **result)
    return result


@contextlib.contextmanager
def plain_versions():
    """Route the kernel entries of the DCP, iPCRNet, PCN, PRNet, FlowNet3D
    and RPMNet paths (K5, K6, K7, K9, K10, K11a/b; K1, K12, K13; K8; K14,
    K15; K16, K17) to the kernels' plain versions (on the same card) for the
    reference run; restored on exit."""
    from learning3d_tpu_torch import quant
    from learning3d_tpu_torch.kernels import attention, chamfer, dgcnn_fused, edgeconv, emd, knn, pointnet_fused
    from learning3d_tpu_torch.kernels import sampling, sinkhorn, transformer_int8
    from learning3d_tpu_torch.models import dgcnn

    def encoder(x, pack, k, approx_knn=False):
        return dgcnn_fused.dgcnn_encode_reference(x.float(), pack.ws, pack.bs, k, approx_knn=approx_knn)

    def fused_layer(layer, x, *memory):
        if not (layer._on_gate(x) and all(m.shape[1] == x.shape[1] for m in memory)):
            return layer.inner(x, *memory)
        ref = transformer_int8.decoder_layer_int8_reference if memory else transformer_int8.encoder_layer_int8_reference
        return ref(x, *memory, layer.weights(), layer.scales, n_heads=layer.n_heads, int8_pv=layer.int8_pv)

    # K6's plain version goes inside attention_fused's autograd Function, so
    # that a train step on the plain versions keeps the kernel path's
    # backward (the oracle's)
    patches = [(dgcnn, "dgcnn_encode_packed", encoder), (edgeconv, "edge_features", edgeconv.edge_features_reference),
               (attention, "attention_pallas", attention.attention_reference),
               (dgcnn, "dgcnn_encode_int8_kernel", dgcnn_fused.dgcnn_int8_reference),
               (quant, "attention_int8", attention.attention_int8_reference),
               (quant.QuantEncoderLayerFused, "forward", fused_layer),
               (quant.QuantDecoderLayerFused, "forward", fused_layer),
               (pointnet_fused, "pointnet_pooled_kernel", pointnet_fused.oracle_chain),
               (chamfer, "nn_oneway", chamfer._nn_oneway_reference), (emd, "emd_kernel", emd._emd_fwd_reference),
               (knn, "knn_pallas", knn.knn_reference), (sampling, "fps_pallas", sampling.fps_reference),
               (sampling, "ball_query_pallas", sampling.ball_query_reference),
               (sampling, "ball_group_pallas", sampling.ball_group_reference),
               (sinkhorn, "sinkhorn_log_pallas", sinkhorn.sinkhorn_slack_reference)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_serve_dcp(model, rng) -> dict:
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.serve import InferenceEngine

    engine = InferenceEngine(model, batch_size=DCP_B)
    requests = [(rng.normal(size=(n, DCP_N, 3)).astype(np.float32), rng.normal(size=(n, DCP_N, 3)).astype(np.float32))
                for n in DCP_REQUESTS]
    chunks = sum(-(-n // DCP_B) for n in DCP_REQUESTS)
    reset_launches()
    outs = [engine(t, s) for t, s in requests]
    torch.cuda.synchronize()
    launches = {name: LAUNCHES[name] for name in ("dgcnn_encode_fused", "attention_pallas")}
    require(launches["dgcnn_encode_fused"] == 2 * chunks,
            f"K5 launched {launches['dgcnn_encode_fused']} times for {chunks} chunks (want 2 a chunk)")
    require(launches["attention_pallas"] == 7 * chunks,
            f"K6 launched {launches['attention_pallas']} times for {chunks} chunks (want 7 a chunk)")
    rot_err = det_err = 0.0
    for (t, _), out in zip(requests, outs):
        n = t.shape[0]
        require(out["est_R"].shape == (n, 3, 3) and out["r"].shape == (n, DCP_N, DCP_EMB), "result shapes")
        for key, val in out.items():
            require(bool(np.isfinite(val).all()), f"every {key} finite")
        R = out["est_R"].astype(np.float64)
        rot_err = max(rot_err, float(np.abs(R @ np.swapaxes(R, -1, -2) - np.eye(3)).max()))
        det_err = max(det_err, float(np.abs(np.linalg.det(R) - 1.0).max()))
    require(rot_err <= ROT_TOL and det_err <= ROT_TOL, f"est_R not a rotation: {rot_err}, {det_err}")

    with plain_versions():
        plain = [engine(t, s) for t, s in requests]
    agree, angles = {}, []
    for key in ("r", "est_t"):
        got = torch.from_numpy(np.concatenate([o[key] for o in outs]))
        want = torch.from_numpy(np.concatenate([p[key] for p in plain]))
        agree[key] = check_close(got, want, f"DCP {key}, kernels vs plain", DCP_TOL)
    for out, ref in zip(outs, plain):
        # the angle of R_k^T R_p from the chord |R_k - R_p|_F = 2 sqrt(2) sin(angle / 2)
        chord = np.linalg.norm((out["est_R"] - ref["est_R"]).astype(np.float64), axis=(-2, -1))
        angles.extend(np.degrees(2.0 * np.arcsin(np.clip(chord / (2.0 * np.sqrt(2.0)), 0.0, 1.0))).tolist())

    template, source = requests[0]
    engine(template, source)
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine(template, source)
    host_s = (time.perf_counter() - t0) / reps
    t_dev, s_dev = torch.from_numpy(template).cuda(), torch.from_numpy(source).cuda()
    with torch.inference_mode():
        model_ms = cuda_ms(lambda: model(t_dev, s_dev), reps=5)
        with plain_versions():
            plain_model_ms = cuda_ms(lambda: model(t_dev, s_dev), reps=2, warmup=1)
    emit("serve_dcp", requests=list(DCP_REQUESTS), chunks=chunks, launches=launches,
         tolerance=f"max|k-p| <= {DCP_TOL}*max|p| for r and est_t",
         agree={k: {"abs": a, "rel": r} for k, (a, r) in agree.items()},
         rotation={"max_RRt_minus_I": rot_err, "max_det_minus_1": det_err},
         angle_vs_plain_deg={"median": float(np.median(angles)), "max": float(np.max(angles))},
         pairs_per_s=DCP_B / host_s, engine_ms=1e3 * host_s, model_ms=model_ms,
         plain_model_ms=plain_model_ms, model_pairs_per_s=DCP_B / (model_ms * 1e-3))
    return launches


def library_pn_int8(x, qm):
    """Yardstick only, never used by the port: the unfused int8 encoder of
    QuantPointNetClassifier (torch._int_mm products, eager epilogues) and the
    pool."""
    from learning3d_tpu_torch.quant import _bf16_linear

    h = torch.relu(_bf16_linear(x, qm.w1, qm.b1))
    for i, q in enumerate(qm.enc):
        h = q(h, relu=i < len(qm.enc) - 1)
    return torch.relu(torch.amax(h, dim=1))


def random_int8_pack(rng, emb: int):
    """A PointNetInt8Weights of numpy-seeded folded weights, per-channel int8
    quantization and static activation scales, on the card."""
    from learning3d_tpu_torch.kernels.pointnet_fused import PointNetInt8Weights

    dims = [3, 64, 64, 64, 128, emb]
    ws = [torch.from_numpy(rng.normal(0, i**-0.5, (i, o)).astype(np.float32)) for i, o in zip(dims[:-1], dims[1:])]
    bs = [torch.from_numpy(rng.normal(0, 0.1, o).astype(np.float32)) for o in dims[1:]]
    qlayers = []
    for w, b in zip(ws[1:], bs[1:]):
        s_w = w.abs().amax(0).clamp_min(1e-12) / 127
        qlayers.append((torch.clamp(torch.round(w / s_w), -127, 127).to(torch.int8), s_w, b,
                        float(rng.uniform(0.01, 0.05))))
    return PointNetInt8Weights(ws[0], bs[0], qlayers).cuda()


def phase_kernel_k2(fused, rng) -> dict:
    """K2 bit for bit against its plain version: the calibrated classifier's
    pack at B=256, N=1024 (the serving chunk), on a ragged B=3, N=1000 cloud
    and at B=32 (the plan's four groups of 256), and a random pack of emb
    512 (B=5, N=777); the first two draw from ``rng``, the others from a
    generator of their own. Times at B=256 and B=32."""
    from learning3d_tpu_torch.kernels.pointnet_fused import pn_int8_reference, pointnet_pooled_int8_kernel

    pack = fused.pack
    own = np.random.default_rng(SEED + 20)
    cases = {}
    for name, shape in (("full", (B, N, 3)), ("ragged", (3, 1000, 3))):
        cases[name] = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda(), pack)
    cases["b32"] = (torch.from_numpy(own.normal(size=(K1_SMALL_B, N, 3)).astype(np.float32)).cuda(), pack)
    cases["emb512"] = (torch.from_numpy(own.normal(size=(5, 777, 3)).astype(np.float32)).cuda(),
                       random_int8_pack(own, 512))
    checked = {}
    with torch.inference_mode():
        for name, (x, p) in cases.items():
            got = pointnet_pooled_int8_kernel(x, p)
            want = pn_int8_reference(x, p)
            torch.cuda.synchronize()
            emb = p.stages()[-1][0].shape[0]
            require(got.shape == (x.shape[0], emb) and got.dtype == torch.float32, f"K2 output {name}")
            require(bool(torch.isfinite(got).all()), f"K2 output finite ({name})")
            differ = int((got != want).sum())
            require(differ == 0, f"K2 vs plain ({name}): {differ} values differ")
            checked[name] = {"B": x.shape[0], "N": x.shape[1], "emb": emb, "values_differing": differ}
        x_full, x32 = cases["full"][0], cases["b32"][0]
        k_ms = cuda_ms(lambda: pointnet_pooled_int8_kernel(x_full, pack))
        k32_ms = cuda_ms(lambda: pointnet_pooled_int8_kernel(x32, pack))
        p_ms = cuda_ms(lambda: pn_int8_reference(x_full, pack), reps=5)
        l_ms = cuda_ms(lambda: library_pn_int8(x_full, fused.qm), reps=5)
    stages = pack.stages()
    macs = sum(wt.numel() for wt, _ in stages)
    nbytes = 4 * B * N * 3 + 4 * (pack.w1.numel() + pack.b1.numel()) \
        + sum(wt.numel() + 4 * swb.numel() for wt, swb in stages) + 4 * B * EMB
    bound_ms, bound_by = bound(0.0, nbytes, int8_ops=2.0 * B * N * macs, f32_flops=2.0 * B * N * pack.w1.numel())
    result = {
        "max_abs_err": 0.0, "max_rel_err": 0.0, "kernel_ms": k_ms, "kernel_ms_b32": k32_ms, "plain_ms": p_ms,
        "library_ms": l_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }
    emit("kernel", name="pointnet_pooled_int8", tolerance="values equal", cases=checked,
         library="QuantPointNetClassifier's unfused int8 encoder (torch._int_mm), yardstick only", **result)
    return result


def phase_serve_int8(model, fused, rng) -> int:
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.kernels.pointnet_fused import pn_int8_reference
    from learning3d_tpu_torch.serve import InferenceEngine

    engine = InferenceEngine(fused, batch_size=B)
    requests = [rng.normal(size=(n, N, 3)).astype(np.float32) for n in REQUESTS]
    chunks = sum(-(-n // B) for n in REQUESTS)
    reset_launches()
    outs = [engine(x) for x in requests]
    torch.cuda.synchronize()
    launches = LAUNCHES["pointnet_pooled_int8"]
    require(launches == chunks, f"K2 launched {launches} times for {chunks} chunks")
    for x, out in zip(requests, outs):
        require(out.shape == (x.shape[0], CLASSES), f"int8 logits shape {out.shape}")
        require(bool(np.isfinite(out).all()), "every int8 logit finite")

    agree = {"plain": 0, "quant_forward": 0, "bf16": 0}
    total = 0
    with torch.inference_mode():
        for x, out in zip(requests, outs):
            xd = torch.from_numpy(x).cuda()
            refs = {"plain": fused.qm.logits(pn_int8_reference(xd, fused.pack)), "quant_forward": fused.qm(xd),
                    "bf16": model(xd)}
            for key, ref in refs.items():
                agree[key] += int((ref.float().cpu().numpy().argmax(-1) == out.argmax(-1)).sum())
            total += x.shape[0]
    agree = {key: val / total for key, val in agree.items()}
    require(agree["plain"] >= AGREE, f"int8 argmax agreement with the plain version {agree['plain']} < {AGREE}")

    x256 = requests[0]
    engine(x256)
    reps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine(x256)
    host_s = (time.perf_counter() - t0) / reps
    x_dev = torch.from_numpy(x256).cuda()
    with torch.inference_mode():
        model_ms = cuda_ms(lambda: fused(x_dev))
        plain_int8_ms = cuda_ms(lambda: fused.qm(x_dev))
    emit("serve_int8", requests=list(REQUESTS), chunks=chunks, launches=launches,
         argmax_agree_plain=agree["plain"], argmax_agree_quant_forward=agree["quant_forward"],
         argmax_agree_bf16=agree["bf16"], clouds_per_s=B / host_s, engine_ms=1e3 * host_s, model_ms=model_ms,
         model_clouds_per_s=B / (model_ms * 1e-3), quant_forward_ms=plain_int8_ms)
    return launches


def library_dgcnn_int8(x, pack, k):
    """Yardstick only, never used by the port: K9's function as an eager
    chain of cuBLAS distances, torch.topk, a gather and torch._int_mm
    products."""
    from learning3d_tpu_torch.kernels.dgcnn_fused import _xw1_int8
    from learning3d_tpu_torch.ops.int8 import int8_matmul, to_int8

    f32, bf = torch.float32, torch.bfloat16
    sq = (x * x).sum(-1)
    d = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.bmm(x, x.transpose(1, 2))
    idx = torch.topk(d, k, dim=-1, largest=False).indices
    xw1q, s_xw1 = _xw1_int8(x, pack.wn1)
    c1 = x.to(bf).to(f32) @ pack.wc1.to(bf).to(f32) + pack.b1
    Bc, Nc, C = xw1q.shape
    nbr = torch.gather(xw1q, 1, idx.reshape(Bc, -1, 1).expand(-1, -1, C)).reshape(Bc, Nc, k, C)
    e = to_int8(torch.relu(nbr.to(f32) * s_xw1 + c1[:, :, None]) * pack.inv_s[0])
    pooled = [e.amax(2)]
    stages = pack.stages()
    for (wt, swb), inv in zip(stages[:3], pack.inv_s[1:]):
        e = to_int8(torch.relu(int8_matmul(e, wt.t()).to(f32) * swb[0] + swb[1]) * inv)
        pooled.append(e.amax(2))
    wt, swb = stages[3]
    return torch.relu(int8_matmul(torch.cat(pooled, -1), wt.t()).to(f32) * swb[0] + swb[1]).to(bf)


def phase_kernel_k9(qdcp, rng) -> dict:
    from learning3d_tpu_torch.kernels.dgcnn_fused import dgcnn_encode_int8_kernel, dgcnn_int8_reference

    pack = qdcp.emb_nn.int8_weights
    cases = {
        "full": rng.normal(size=(DCP_B, DCP_N, 3)).astype(np.float32),
        "ragged": rng.normal(size=(3, 1000, 3)).astype(np.float32),
        "ties": lattice_cloud(rng, 2, 1000),
    }
    errs = {}
    with torch.inference_mode():
        for name, x_np in cases.items():
            x = torch.from_numpy(x_np).cuda()
            got = dgcnn_encode_int8_kernel(x, pack, DCP_K)
            want = dgcnn_int8_reference(x, pack, DCP_K)
            torch.cuda.synchronize()
            errs[name] = check_close(got, want, f"K9 vs plain ({name})")
        x = torch.from_numpy(cases["full"]).cuda()
        k_ms = cuda_ms(lambda: dgcnn_encode_int8_kernel(x, pack, DCP_K))
        p_ms = cuda_ms(lambda: dgcnn_int8_reference(x, pack, DCP_K), reps=3, warmup=1)
        l_ms = cuda_ms(lambda: library_dgcnn_int8(x, pack, DCP_K), reps=5)
    stages = pack.stages()
    macs = DCP_K * sum(wt.numel() for wt, _ in stages[:3]) + stages[3][0].numel()  # a point
    # x and xw1q read once, the weights once, the output written once
    nbytes = 4 * DCP_B * DCP_N * 3 + DCP_B * DCP_N * 64 + sum(wt.numel() + 4 * swb.numel() for wt, swb in stages) \
        + 2 * DCP_B * DCP_N * DCP_EMB
    # distances: 3 differences, 3 products and 2 sums a pair (instructions,
    # none fused); the center half of stage 1 (FMAs)
    bound_ms, bound_by = bound(0.0, nbytes, int8_ops=2.0 * DCP_B * DCP_N * macs,
                               f32_flops=2.0 * DCP_B * DCP_N * 3 * 64, f32_ops=8.0 * DCP_B * DCP_N * DCP_N)
    result = {
        "max_abs_err": max(a for a, _ in errs.values()), "max_rel_err": max(r for _, r in errs.values()),
        "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }
    emit("kernel", name="dgcnn_encode_fused_int8", tolerance=f"max|k-p| <= {TOL}*max|p|",
         shape={"B": DCP_B, "N": DCP_N, "k": DCP_K, "emb": DCP_EMB},
         errors={k: {"abs": a, "rel": r} for k, (a, r) in errs.items()},
         library="eager cuBLAS distances + torch.topk + gather + torch._int_mm chain, yardstick only", **result)
    return result


def attention_int8_bound(b, h, n, m, d, int8_pv) -> tuple[float, str]:
    ops = 2.0 * b * h * n * m * d
    nbytes = b * h * (n + 2 * m) * d + 2 * b * h * n * d
    return bound(0.0 if int8_pv else ops, nbytes, int8_ops=2 * ops if int8_pv else ops)


def attention_int8_floor3(b, h, n, m, d, int8_pv) -> float:
    """K10's least time with the exact max (ms): Q K^T twice in int8 and
    P V once, in int8 or bf16."""
    ops = 2.0 * b * h * n * m * d
    return 1e3 * ((3 if int8_pv else 2) * ops / PEAK_INT8_OPS + (0 if int8_pv else ops) / PEAK_BF16_FLOPS)


def phase_kernel_k10(rng) -> dict:
    from learning3d_tpu_torch.kernels.attention import attention_int8_kernel, attention_int8_reference

    def qkv(b, h, n, m, d, gen=rng):
        return [torch.from_numpy(gen.integers(-127, 128, (b, h, s, d)).astype(np.int8)).cuda() for s in (n, m, m)]

    s_q, s_k, s_v = 0.004, 0.005, 0.03
    edge_rng = np.random.default_rng([SEED, 10, 14])  # cases added later draw apart from the shared stream
    cases = {"pointer": qkv(DCP_B, 4, DCP_N, DCP_N, 128), "ragged": qkv(4, 4, 1000, 1000, 128),
             # the edges of the 128-key tiles and 128-row blocks, D = 256 and
             # 512 (shallower rings), and two heads side by side whose second
             # head's keys are all 127
             "n37_m200_d256": qkv(1, 1, 37, 200, 256, gen=edge_rng),
             "n768_m768": qkv(1, 2, 768, 768, 128, gen=edge_rng),
             "n100_m1000": qkv(1, 1, 100, 1000, 128, gen=edge_rng),
             "n40_m300_d512": qkv(1, 1, 40, 300, 512, gen=edge_rng),
             "heads_side_by_side": side_by_side_heads(*qkv(1, 2, 100, 200, 128, gen=edge_rng), 127)}
    errs, times = {}, {}
    with torch.inference_mode():
        q, k, v = cases["pointer"]
        deq = [(t.float() * s).to(torch.bfloat16) for t, s in ((q, s_q), (k, s_k), (v, s_v))]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        l_ms = cuda_ms(lambda: sdpa(*deq))
        for int8_pv in (True, False):
            mode = "int8_pv" if int8_pv else "hybrid"
            for name, (q, k, v) in cases.items():
                got = attention_int8_kernel(q, k, v, s_q, s_k, s_v, int8_pv)
                want = attention_int8_reference(q, k, v, s_q, s_k, s_v, int8_pv)
                torch.cuda.synchronize()
                if name == "heads_side_by_side":
                    for h in range(2):
                        check_close(got[:, h], want[:, h], f"K10 vs plain ({mode}, {name}, head {h})")
                    if not int8_pv:  # the bf16 V the hybrid reads, the second head's inf
                        v16 = v.to(torch.bfloat16)
                        v16[:, 1] = float("inf")
                        errs[f"{mode}/{name}_inf_v"] = check_first_head(
                            k10_hybrid_bf16_v(q, k, v16, s_q, s_k, s_v),
                            attention_int8_reference(q, k, v, s_q, s_k, s_v, False), f"K10 ({mode}, {name}, inf V)")
                errs[f"{mode}/{name}"] = check_close(got, want, f"K10 vs plain ({mode}, {name})")
            q, k, v = cases["pointer"]
            times[mode] = {
                "kernel_ms": cuda_ms(lambda: attention_int8_kernel(q, k, v, s_q, s_k, s_v, int8_pv)),
                "plain_ms": cuda_ms(lambda: attention_int8_reference(q, k, v, s_q, s_k, s_v, int8_pv),
                                    reps=3, warmup=1),
                "library_ms": l_ms,
                "floor3_ms": attention_int8_floor3(DCP_B, 4, DCP_N, DCP_N, 128, int8_pv),
                "instance": K10_INSTANCE,
            }
            times[mode]["bound_ms"], times[mode]["bound_by"] = attention_int8_bound(DCP_B, 4, DCP_N, DCP_N, 128,
                                                                                    int8_pv)
    exp_sfu_ms = 1e3 * DCP_B * 4 * DCP_N * DCP_N / SFU_EXP_PER_S
    served = times["int8_pv"]
    result = {
        "max_abs_err": max(a for a, _ in errs.values()), "max_rel_err": max(r for _, r in errs.values()),
        "kernel_ms": served["kernel_ms"], "plain_ms": served["plain_ms"], "library_ms": l_ms,
        "bound_ms": served["bound_ms"], "bound_by": served["bound_by"], "hybrid": times["hybrid"],
    }
    emit("kernel", name="attention_int8", tolerance=f"max|k-p| <= {TOL}*max|p|",
         shape=[DCP_B, 4, DCP_N, DCP_N, 128], errors={k: {"abs": a, "rel": r} for k, (a, r) in errs.items()},
         times=times, exp_sfu_ms=exp_sfu_ms,
         library="torch scaled_dot_product_attention on the dequantized bf16 q, k, v, yardstick only", **result)
    return result


def dcp_gates(outs, plain, what) -> dict:
    """The DCP output gates: shapes, every output finite, every est_R a
    rotation, r and est_t within DCP_TOL of the plain versions' run."""
    rot_err = det_err = 0.0
    for out in outs:
        n = out["est_R"].shape[0]
        require(out["r"].shape == (n, DCP_N, DCP_EMB), f"{what} result shapes")
        for key, val in out.items():
            require(bool(np.isfinite(val).all()), f"every {what} {key} finite")
        R = out["est_R"].astype(np.float64)
        rot_err = max(rot_err, float(np.abs(R @ np.swapaxes(R, -1, -2) - np.eye(3)).max()))
        det_err = max(det_err, float(np.abs(np.linalg.det(R) - 1.0).max()))
    require(rot_err <= ROT_TOL and det_err <= ROT_TOL, f"{what} est_R not a rotation: {rot_err}, {det_err}")
    agree = {}
    for key in ("r", "est_t"):
        got = torch.from_numpy(np.concatenate([o[key] for o in outs]))
        want = torch.from_numpy(np.concatenate([p[key] for p in plain]))
        a, r = check_close(got, want, f"{what} {key}, kernels vs plain", DCP_TOL)
        agree[key] = {"abs": a, "rel": r}
    return {"tolerance": f"max|k-p| <= {DCP_TOL}*max|p| for r and est_t", "agree": agree,
            "rotation": {"max_RRt_minus_I": rot_err, "max_det_minus_1": det_err}}


def phase_serve_dcp_variant(phase, model, rng, per_chunk, requests=DCP_REQUESTS, template=False, served=None,
                            **extra) -> dict:
    """Serve an int8 DCP clone through InferenceEngine (or, with
    ``template``, TemplateRegistrar against one template), hold the launch
    counts of the kernels a chunk (``per_chunk``; every other kernel of
    LAUNCHES 0, unless listed) and the DCP gates against the same model on
    the plain versions; time a 32-pair request. The clouds of every request
    are drawn and the first ``served`` (all for None) served, so that the
    later phases that share ``rng`` keep their data."""
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.serve import InferenceEngine, TemplateRegistrar

    cloud = lambda n: rng.normal(size=(n, DCP_N, 3)).astype(np.float32)  # noqa: E731
    if template:
        tmpl = cloud(1)[0]
        sources = [cloud(n) for n in requests]
        engine = TemplateRegistrar(model, tmpl, batch_size=DCP_B)
        calls = [(s,) for s in sources]
    else:
        engine = InferenceEngine(model, batch_size=DCP_B)
        calls = [(cloud(n), cloud(n)) for n in requests]
    requests, calls = requests[:served], calls[:served]
    chunks = sum(-(-n // DCP_B) for n in requests)
    reset_launches()
    outs = [engine(*c) for c in calls]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    for name, count in launches.items():
        want = per_chunk.get(name, 0) * chunks
        require(count == want, f"{phase}: {name} launched {count} times for {chunks} chunks (want {want})")
    with plain_versions():
        plain_engine = TemplateRegistrar(model, tmpl, batch_size=DCP_B) if template else engine
        plain = [plain_engine(*c) for c in calls]
    gates = dcp_gates(outs, plain, phase)

    first = calls[0]
    engine(*first)
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine(*first)
    host_s = (time.perf_counter() - t0) / reps
    dev = [torch.from_numpy(a).cuda() for a in first]
    with torch.inference_mode():
        if template:
            temb = engine._temb.expand(DCP_B, -1, -1)
            tdev = engine._template.expand(DCP_B, -1, -1)
            model_ms = cuda_ms(lambda: model.register_encoded(tdev, temb, dev[0]), reps=5)
        else:
            model_ms = cuda_ms(lambda: model(*dev), reps=5)
    emit(phase, requests=list(requests), chunks=chunks,
         launches={k: v for k, v in launches.items() if v}, **gates, pairs_per_s=DCP_B / host_s,
         engine_ms=1e3 * host_s, model_ms=model_ms, model_pairs_per_s=DCP_B / (model_ms * 1e-3), **extra)
    return launches


LAYER_TOL = {"max_abs": 0.08, "atol": 2e-4, "frac": 0.01}  # the JAX package's K11 test


def tie_flip_profile(got, want, what) -> dict:
    """K11 against its plain version: max |diff| < 0.08 and under 1% of the
    elements above 2e-4 (an f32 sum in another order flips round(x / s) at
    a .5 tie, rarely; a wrong kernel moves every element)."""
    require(got.shape == want.shape and bool(torch.isfinite(got).all()), f"{what}: shape and finite")
    d = (got.float() - want.float()).abs()
    max_abs, frac = d.max().item(), (d > LAYER_TOL["atol"]).float().mean().item()
    require(max_abs < LAYER_TOL["max_abs"] and frac < LAYER_TOL["frac"],
            f"{what}: max |diff| {max_abs}, share above {LAYER_TOL['atol']} {frac}")
    return {"max_abs": max_abs, "share_above_atol": frac}


def k11_bound(batch, n, d, d_ff, heads, decoder, int8_pv) -> tuple[float, str]:
    """K11's bound: its int8 GEMMs and attention products (the hybrid P.V at
    the bf16 rate); its bytes: x (and the memory) read once as bf16, the
    int8 weights and their f32 vectors once, the output written once."""
    rows = batch * n
    gemm = 2.0 * rows * d * (3 * d + d + 2 * d_ff) + (2.0 * rows * d * 4 * d if decoder else 0.0)
    att = 2.0 * batch * heads * n * n * (d // heads) * (2 if decoder else 1)  # Q K^T, and as much for P V
    weights = d * (4 * d + 2 * d_ff) * (2 if decoder else 1)
    vectors = 4 * 3 * (4 * d + 2 * d_ff) * (2 if decoder else 1)
    nbytes = 2 * rows * d * (3 if decoder else 2) + weights + vectors
    return bound(0.0 if int8_pv else att, nbytes, int8_ops=gemm + (2 * att if int8_pv else att))


def phase_kernel_k11(layers, inputs) -> dict:
    """``layers``: {int8_pv: (QuantEncoderLayerFused, QuantDecoderLayerFused)}
    of the served clones; ``inputs``: bf16 encoder features x, memory."""
    from learning3d_tpu_torch.kernels import transformer_int8 as k11

    x_full, mem_full = inputs
    d, heads = x_full.shape[-1], layers[True][0].n_heads
    d_ff = layers[True][0].inner.ff.w1_q.shape[1]
    results, errs = {}, {}
    with torch.inference_mode():
        for int8_pv, (enc, dec) in layers.items():
            mode = "int8_pv" if int8_pv else "hybrid"
            for kind, layer in (("encoder", enc), ("decoder", dec)):
                ref = k11.decoder_layer_int8_reference if kind == "decoder" else k11.encoder_layer_int8_reference
                entry = k11.decoder_layer_int8 if kind == "decoder" else k11.encoder_layer_int8
                for n in (DCP_N, 512):
                    args = (x_full[:, :n].contiguous(),) + ((mem_full[:, :n].contiguous(),) if kind == "decoder" else ())
                    require(k11.fused_layer_ok(n, d, heads), f"K11 gate at N={n}")
                    got = entry(*args, layer.pack, int8_pv=int8_pv)
                    want = ref(*args, layer.weights(), layer.scales, n_heads=heads, int8_pv=int8_pv)
                    torch.cuda.synchronize()
                    errs[f"{kind}/{mode}/N{n}"] = tie_flip_profile(got, want, f"K11 {kind} {mode} N={n}")
                args = (x_full,) + ((mem_full,) if kind == "decoder" else ())
                res = {
                    "kernel_ms": cuda_ms(lambda: entry(*args, layer.pack, int8_pv=int8_pv)),
                    "plain_ms": cuda_ms(lambda: ref(*args, layer.weights(), layer.scales, n_heads=heads,
                                                    int8_pv=int8_pv), reps=1, warmup=1, runs=1),
                    "library_ms": cuda_ms(lambda: layer.inner(*args), reps=5),
                }
                res["bound_ms"], res["bound_by"] = k11_bound(DCP_B, DCP_N, d, d_ff, heads, kind == "decoder", int8_pv)
                results[f"{kind}/{mode}"] = res
    out = {}
    for kind in ("encoder", "decoder"):
        served = results[f"{kind}/int8_pv"]
        kerrs = {k: v for k, v in errs.items() if k.startswith(kind)}
        out[kind] = {
            **served, "max_abs_err": max(e["max_abs"] for e in kerrs.values()),
            "max_rel_err": max(e["max_abs"] for e in kerrs.values()) / max(x_full.float().abs().max().item(), 1e-30),
            "hybrid": results[f"{kind}/hybrid"],
        }
        emit("kernel", name=f"{kind}_layer_int8",
             tolerance=f"max|k-p| < {LAYER_TOL['max_abs']}, under {LAYER_TOL['frac']} of elements above "
                       f"{LAYER_TOL['atol']}",
             shape={"B": DCP_B, "N": [DCP_N, 512], "d": d, "heads": heads, "ff": d_ff}, errors=kerrs,
             attention_instances={m: k11.attention_instance(d // heads, m == "int8_pv")
                                  for m in ("int8_pv", "hybrid")},
             library="the unfused int8 layer (QuantMHA + QuantFF: K10 and torch._int_mm), yardstick only",
             **out[kind])
    return out


def approx_pick_share(x, k) -> float:
    """The share of (query, neighbor) picks of approx kNN that exact kNN
    does not make."""
    from learning3d_tpu_torch.kernels.dgcnn_fused import approx_knn_indices, exact_knn

    a, e = approx_knn_indices(x, k), exact_knn(x, k)
    same = (a[..., :, None] == e[..., None, :]).any(-1)
    return 1.0 - same.float().mean().item()


def phase_approx_kernels(dcp, qdcp, rng) -> dict:
    """K5 and K9 with approx_knn=True against their plain versions on the
    full and a two-tile (N=320) cloud."""
    from learning3d_tpu_torch.kernels.dgcnn_fused import (
        dgcnn_encode_int8_kernel, dgcnn_encode_kernel, dgcnn_encode_packed, dgcnn_encode_reference,
        dgcnn_int8_reference)

    ws, bs = folded_dgcnn(dcp)
    pack = qdcp.emb_nn.int8_weights
    pack5 = dcp.emb_nn.bf16_weights()
    errs = {}
    with torch.inference_mode():
        for name, shape in (("full", (DCP_B, DCP_N, 3)), ("two_tiles", (3, 320, 3))):
            x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
            for kname, got, want in (
                    ("K5", dgcnn_encode_kernel(x, ws, bs, DCP_K, approx_knn=True),
                     dgcnn_encode_reference(x, ws, bs, DCP_K, approx_knn=True)),
                    ("K9", dgcnn_encode_int8_kernel(x, pack, DCP_K, approx_knn=True),
                     dgcnn_int8_reference(x, pack, DCP_K, approx_knn=True))):
                torch.cuda.synchronize()
                a, r = check_close(got, want, f"{kname} approx vs plain ({name})")
                errs[f"{kname}/{name}"] = {"abs": a, "rel": r}
            if name == "full":
                share = approx_pick_share(x, DCP_K)
                k5_ms = cuda_ms(lambda: dgcnn_encode_packed(x, pack5, DCP_K, approx_knn=True))
                k9_ms = cuda_ms(lambda: dgcnn_encode_int8_kernel(x, pack, DCP_K, approx_knn=True))
    emit("kernel_approx_knn", tolerance=f"max|k-p| <= {TOL}*max|p|", errors=errs, k5_ms=k5_ms, k9_ms=k9_ms,
         picks_differing_from_exact=share)
    return {"share": share}


def pool_tail_inputs(rng, batch: int, n_pts: int, emb: int, dtype):
    """The fused tail's operands as the train step hands them over: ReLU'd
    activations (many zeros, so a few critical points win many channels),
    conv5's W (K, E) and c, on the card in ``dtype``."""
    x = np.maximum(rng.normal(size=(batch, n_pts, K_TAIL)), 0.0).astype(np.float32)
    w = rng.normal(0.0, K_TAIL**-0.5, (K_TAIL, emb)).astype(np.float32)
    c = rng.normal(0.0, 0.1, emb).astype(np.float32)
    return [torch.from_numpy(a).cuda().to(dtype) for a in (x, w, c)]


def library_pool_stats(x, w, c):
    """Yardstick only, never used by the port: z materialized by
    torch.matmul, torch.max/min with indices, x^T x and the column sum,
    eagerly in x's dtype."""
    z = torch.matmul(x, w) + c
    mx, amax = torch.max(z, dim=1)
    mn, amin = torch.min(z, dim=1)
    flat = x.reshape(-1, x.shape[-1])
    return mx, mn, amax, amin, flat.t() @ flat, flat.sum(0)


def k3_bound(x, w) -> tuple[float, str]:
    """K3's bound: z's and G's multiply-adds (for f32 operands the three
    bf16 products of each hi/lo split, as the kernel computes them); x, W
    and c read once, the four (B, E) outputs, G and the column sum written
    once."""
    B, N, K = x.shape
    E = w.shape[1]
    flops = 2.0 * B * N * K * (E + K) * (3 if x.dtype == torch.float32 else 1)
    nbytes = (x.numel() + w.numel()) * x.element_size() + 4 * E + 4 * 4 * B * E + 4 * (K * K + K)
    return bound(flops, nbytes)


def pool_stats_gaps(got, want, x, w, c, what) -> dict:
    """K3's outputs against the plain version's, each relative to the
    largest plain value: max/min, z at the kernel's argmax/argmin, G and
    the column sum (the indices checked for range first)."""
    mx, mn, amax, amin, G, cs = got
    n_pts = x.shape[1]
    for ai in (amax, amin):
        require(ai.dtype == torch.int32 and int(ai.min()) >= 0 and int(ai.max()) < n_pts, f"K3 {what}: index range")
    scale = max(want[0].abs().max().item(), want[1].abs().max().item())
    abs_err = max((mx - want[0]).abs().max().item(), (mn - want[1]).abs().max().item())
    z = torch.matmul(x.float(), w.float()) + c.float()
    at_err = max((torch.gather(z, 1, ai.long()[:, None, :])[:, 0] - ref).abs().max().item()
                 for ai, ref in ((amax, want[0]), (amin, want[1])))
    rel = lambda g, r: (g - r).abs().max().item() / max(r.abs().max().item(), 1e-30)  # noqa: E731
    return {"abs": abs_err, "max_min": abs_err / scale, "z_at_index": at_err / scale, "G": rel(G, want[4]),
            "colsum": rel(cs, want[5])}


def pool_stats_errors(got, want, x, w, c, what) -> dict:
    gaps = pool_stats_gaps(got, want, x, w, c, what)
    require(gaps["max_min"] <= TOL, f"K3 {what}: max/min err {gaps['abs']} > {TOL} of max")
    for key in ("G", "colsum"):
        require(gaps[key] <= POOL_SUM_TOL, f"K3 {what}: {key} rel err {gaps[key]}")
    require(gaps["z_at_index"] <= TOL, f"K3 {what}: z at the kernel's argmax/argmin off the plain max/min by "
                                       f"{gaps['z_at_index']} of max")
    differ = 0.5 * ((got[2] != want[2]).float().mean().item() + (got[3] != want[3]).float().mean().item())
    return {"abs": gaps["abs"], "rel": gaps["max_min"], "G_rel": gaps["G"], "colsum_rel": gaps["colsum"],
            "z_at_index_rel": gaps["z_at_index"], "indices_differing": differ}


def phase_kernel_k3(rng) -> tuple[dict, dict]:
    """K3 against its plain version; returns the result and, per case, the
    inputs and the kernel's outputs (K4 takes its indices from them)."""
    from learning3d_tpu_torch.kernels.poolgrad import pool_stats, pool_stats_reference

    shapes = {"full": (B, N, torch.bfloat16), "f32": (B, N, torch.float32), "ragged": (3, 1000, torch.bfloat16)}
    errs, cases = {}, {}
    with torch.inference_mode():
        for name, (b, n, dt) in shapes.items():
            x, w, c = pool_tail_inputs(rng, b, n, EMB, dt)
            got = pool_stats(x, w, c)
            want = pool_stats_reference(x, w, c)
            torch.cuda.synchronize()
            errs[name] = pool_stats_errors(got, want, x, w, c, name)
            cases[name] = ((x, w, c), got)
            del want
        x, w, c = cases["full"][0]
        k_ms = cuda_ms(lambda: pool_stats(x, w, c))
        p_ms = cuda_ms(lambda: pool_stats_reference(x, w, c), reps=3, warmup=1)
        l_ms = cuda_ms(lambda: library_pool_stats(x, w, c))
        xf, wf, cf = cases["f32"][0]
        f32_ms = cuda_ms(lambda: pool_stats(xf, wf, cf))
        f32_plain_ms = cuda_ms(lambda: pool_stats_reference(xf, wf, cf), reps=3, warmup=1)
        f32_library_ms = cuda_ms(lambda: library_pool_stats(xf, wf, cf))
    bound_ms, bound_by = k3_bound(x, w)
    f32_bound = k3_bound(xf, wf)[0]
    result = {
        "max_abs_err": max(e["abs"] for e in errs.values()), "max_rel_err": max(e["rel"] for e in errs.values()),
        "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }
    emit("kernel", name="pool_stats_pallas",
         tolerance=f"max/min and z at the indices <= {TOL}*max|plain|; G, colsum <= {POOL_SUM_TOL}*max|plain|",
         shape={"B": B, "N": N, "K": K_TAIL, "E": EMB}, errors=errs, f32_kernel_ms=f32_ms, f32_bound_ms=f32_bound,
         f32_plain_ms=f32_plain_ms, f32_library_ms=f32_library_ms,
         library="eager torch.matmul (z materialized) + torch.max/min with indices + x^T x, yardstick only",
         **result)
    return result, cases


def library_pool_bwd(idx, dsel, w, x):
    """Yardstick only, never used by the port: index_add_ of the dsel-scaled
    weight columns and a gathered einsum."""
    Bq, Nq, K = x.shape
    E = idx.shape[1]
    il = idx.long()
    rows = (il + Nq * torch.arange(Bq, device=x.device)[:, None]).reshape(-1)
    vals = (dsel[:, :, None] * w.t()[None].float()).reshape(Bq * E, K)
    dx = torch.zeros(Bq * Nq, K, device=x.device).index_add_(0, rows, vals)
    x_sel = torch.gather(x, 1, il[:, :, None].expand(Bq, E, K))
    return dx.view(Bq, Nq, K), torch.einsum("bek,be->ke", x_sel.float(), dsel)


def k4_bound(idx, w, x) -> tuple[float, str]:
    """K4's bound: dx_sp and dW_sel written once, idx, dsel and W read
    once, and the x rows this run's indices pick (each distinct row once);
    2 * B * E * K f32 multiply-adds on the CUDA cores."""
    Bq, Nq, K = x.shape
    E = idx.shape[1]
    rows = (idx.long() + Nq * torch.arange(Bq, device=x.device)[:, None]).unique().numel()
    nbytes = 4 * Bq * Nq * K + 4 * K * E + 8 * Bq * E + w.numel() * w.element_size() + rows * K * x.element_size()
    return bound(0.0, nbytes, f32_flops=4.0 * Bq * E * K)


def phase_kernel_k4(rng, k3_cases) -> dict:
    from learning3d_tpu_torch.kernels.poolgrad import pool_bwd, pool_bwd_reference

    cases = {name: (inp[0], inp[1], out[2]) for name, (inp, out) in k3_cases.items()}
    x, w, _ = k3_cases["full"][0]
    cases["one_point"] = (x, w, torch.full((B, EMB), 17, dtype=torch.int32, device="cuda"))
    errs, timed = {}, {}
    with torch.inference_mode():
        for name, (x, w, idx) in cases.items():
            dsel = torch.from_numpy(rng.normal(size=idx.shape).astype(np.float32)).cuda()
            dx, dw = pool_bwd(idx, dsel, w, x)
            want_dx, want_dw = pool_bwd_reference(idx, dsel, w, x)
            torch.cuda.synchronize()
            a1, r1 = check_close(dx, want_dx, f"K4 dx_sp ({name})", POOL_SUM_TOL)
            a2, r2 = check_close(dw, want_dw, f"K4 dW_sel ({name})", POOL_SUM_TOL)
            touched = torch.zeros(x.shape[:2], dtype=torch.bool, device="cuda").scatter_(1, idx.long(), True)
            require(bool((dx[~touched] == 0).all()), f"K4 ({name}): untouched rows of dx_sp are 0")
            errs[name] = {"abs": max(a1, a2), "rel": max(r1, r2), "dx_rel": r1, "dW_rel": r2}
            if name in ("full", "f32"):
                timed[name] = (idx, dsel, w, x)
        full, f32 = timed["full"], timed["f32"]
        k_ms = cuda_ms(lambda: pool_bwd(*full))
        p_ms = cuda_ms(lambda: pool_bwd_reference(*full), reps=5)
        l_ms = cuda_ms(lambda: library_pool_bwd(*full), reps=5)
        f32_ms = cuda_ms(lambda: pool_bwd(*f32))
        f32_plain_ms = cuda_ms(lambda: pool_bwd_reference(*f32), reps=5)
        f32_library_ms = cuda_ms(lambda: library_pool_bwd(*f32), reps=5)
    bound_ms, bound_by = k4_bound(full[0], full[2], full[3])
    result = {
        "max_abs_err": max(e["abs"] for e in errs.values()), "max_rel_err": max(e["rel"] for e in errs.values()),
        "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }
    emit("kernel", name="pool_bwd_pallas", tolerance=f"dx_sp, dW_sel <= {POOL_SUM_TOL}*max|plain|",
         shape={"B": B, "N": N, "K": K_TAIL, "E": EMB}, errors=errs, f32_kernel_ms=f32_ms,
         f32_bound_ms=k4_bound(f32[0], f32[2], f32[3])[0], f32_plain_ms=f32_plain_ms, f32_library_ms=f32_library_ms,
         distinct_rows_picked=int((full[0].long() + N * torch.arange(B, device="cuda")[:, None]).unique().numel()),
         library="index_add_ + gathered einsum (f32), yardstick only", **result)
    return result


@contextlib.contextmanager
def plain_poolgrad():
    """Route the train-mode fused tail to K3's and K4's plain versions (on
    the same card); restored on exit."""
    from learning3d_tpu_torch.kernels import poolgrad
    from learning3d_tpu_torch.utils import layers

    saved = layers.pool_stats, layers.pool_bwd
    layers.pool_stats, layers.pool_bwd = poolgrad.pool_stats_reference, poolgrad.pool_bwd_reference
    try:
        yield
    finally:
        layers.pool_stats, layers.pool_bwd = saved


def pool_stats_f64(x, W, c):
    """K3's function with exact sums: z, G and the column sum in f64, each
    rounded to f32 once; argmax/argmin the first of equal f32 values."""
    f64 = torch.float64
    B, N, K = x.shape
    z = (torch.matmul(x.to(f64), W.to(f64)) + c.to(f64)).float()
    mx, mn = z.amax(1), z.amin(1)
    row = torch.arange(N, device=x.device).view(1, N, 1)
    amax = torch.where(z == mx[:, None, :], row, N).amin(1).to(torch.int32)
    amin = torch.where(z == mn[:, None, :], row, N).amin(1).to(torch.int32)
    flat = x.to(f64).reshape(B * N, K)
    return mx, mn, amax, amin, (flat.t() @ flat).float(), flat.sum(0).float()


@contextlib.contextmanager
def plain_f64_sums():
    """The plain versions of K3 and K4 with K3's sums exact
    (``pool_stats_f64``): how far the step moves when only the rounding of
    the Gram matrix and the column sums changes."""
    from learning3d_tpu_torch.kernels import poolgrad
    from learning3d_tpu_torch.utils import layers

    saved = layers.pool_stats, layers.pool_bwd
    layers.pool_stats, layers.pool_bwd = pool_stats_f64, poolgrad.pool_bwd_reference
    try:
        yield
    finally:
        layers.pool_stats, layers.pool_bwd = saved


@contextlib.contextmanager
def k6_bf16_output():
    """The control of the DCP step's check: K6 with its f32 output rounded
    to bf16, the value a bf16 store in the kernel would give, as if the
    kernel computed below the configuration's f32."""
    from learning3d_tpu_torch.kernels import attention

    kernel = attention.attention_pallas
    attention.attention_pallas = lambda q, k, v: kernel(q, k, v).to(torch.bfloat16).to(q.dtype)
    try:
        yield
    finally:
        attention.attention_pallas = kernel


def step_runs(make_trainer, batch, contexts) -> list:
    """(loss, gradients, buffers) of one forward and backward through a
    fresh trainer inside each context."""
    runs = []
    for ctx in contexts:
        trainer = make_trainer()
        with ctx():
            loss, _ = trainer.forward_backward(batch)
        torch.cuda.synchronize()
        trainer.close()
        grads = {n: p.grad for n, p in trainer.model.named_parameters()}
        runs.append((loss.float().item(), grads, dict(trainer.model.named_buffers())))
    return runs


def step_differences(run, ref, tol, zero_gradient, noise_tol) -> tuple[dict, dict]:
    """Per-tensor relative errors of one (loss, gradients, buffers) run
    against a reference run: (the worst of each kind, the tensors past
    their limit)."""
    (lk, gk, bk), (lp, gp, bp) = run, ref
    worst = {"loss": abs(lk - lp) / abs(lp), "grad": 0.0, "zero_gradient_bias": 0.0, "running": 0.0}
    failed = {}
    for name, g in gk.items():
        err = (g - gp[name]).norm().item()
        if name in zero_gradient:
            rel = err / gp[name.rsplit(".", 1)[0] + ".weight"].norm().item()
            key, limit = "zero_gradient_bias", noise_tol
        else:
            # a gradient that is 0 on both sides (a parameter no loss term
            # reaches) agrees; 0 on one side only does not
            ref = gp[name].norm().item()
            rel, key, limit = (err / ref if ref else (0.0 if err == 0.0 else float("inf"))), "grad", tol
        if rel >= worst[key]:
            worst[key], worst[f"{key}_tensor"] = rel, name
        if not rel <= limit:
            failed[name] = rel
    for name, b in bk.items():
        rel = (b - bp[name]).abs().max().item() / max(bp[name].abs().max().item(), 1e-30)
        worst["running"] = max(worst["running"], rel)
        if not rel <= tol:
            failed[name] = rel
    return worst, failed


def step_agreement(make_trainer, batch, tol, plain, zero_gradient=ZERO_GRADIENT_BIASES, noise_tol=NOISE_TOL,
                   what="train step", control=None) -> dict:
    """One forward and backward through the Trainer on the kernels against
    the same on their plain versions (the context ``plain``; fresh trainers:
    same weights, the same augmentation and dropout generators): loss, every
    gradient and the BN running statistics, per-tensor relative error; the
    ``zero_gradient`` biases against their layer's weight gradient. A
    ``control`` context, if given, is a known departure from the plain
    versions that the tolerance must catch: its step is run as well and
    must fail the comparison."""
    runs = step_runs(make_trainer, batch, (contextlib.nullcontext, plain) + ((control,) if control else ()))
    worst, failed = step_differences(runs[0], runs[1], tol, zero_gradient, noise_tol)
    require(np.isfinite(runs[0][0]) and worst["loss"] <= tol, f"{what}: loss {runs[0][0]} vs plain {runs[1][0]}")
    require(not failed, f"{what}: kernels vs plain versions {failed}")
    if control:
        caught, failed = step_differences(runs[2], runs[1], tol, zero_gradient, noise_tol)
        require(bool(failed) or caught["loss"] > tol, f"{what}: the control passed the tolerance {tol}: {caught}")
        worst["control"] = {"loss": caught["loss"], "grad": caught["grad"], "grad_tensor": caught["grad_tensor"],
                            "tensors_failed": len(failed)}
    return worst


def time_train_step(trainer, batch, reps: int = 5, unit: str = "clouds") -> dict:
    """The step's parts on one device batch, CUDA events: forward
    (augmentation, if any, and loss), backward (with the gradient guard),
    optimizer; and the whole step on the host clock, with its rate in
    ``unit`` (batch items) a second."""
    params = [p for p in trainer.model.parameters() if p.requires_grad]
    parts = {"forward_ms": [], "backward_ms": [], "optimizer_ms": []}
    trainer.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for p in params:
            p.grad = None
        ev[0].record()
        b = batch if trainer.augment_fn is None else trainer.augment_fn(trainer.generator, batch)
        loss, _ = trainer.loss_fn(trainer.model, b, trainer.generator)
        ev[1].record()
        loss.backward()
        for p in params:  # as Trainer.forward_backward: a parameter no loss term reaches gets zeros
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        trainer.guard_grads([p.grad for p in params])
        ev[2].record()
        trainer.update()
        ev[3].record()
        ev[3].synchronize()
        for key, (a, z) in zip(parts, zip(ev, ev[1:])):
            parts[key].append(a.elapsed_time(z))
    step_s = (time.perf_counter() - t0) / reps
    out = {k: statistics.median(v) for k, v in parts.items()}
    out["step_ms"] = 1e3 * step_s
    out[f"{unit}_per_s"] = batch[0].shape[0] / step_s
    return out


def check_trained(trainer, before) -> tuple[int, dict]:
    """After ``Trainer.fit``: the last epoch's loss finite, no step skipped
    by the non-finite guard, every weight and running statistic changed.
    -> (skipped steps, {tensor: changed})."""
    loss = trainer.history[-1]["train_loss"]
    require(np.isfinite(loss), f"train loss {loss}")
    skipped = int(trainer.skipped_steps)
    require(skipped == 0, f"{skipped} steps skipped as non-finite")
    after = trainer.model.state_dict()
    changed = {k: not torch.equal(before[k], after[k]) for k in before}
    require(all(v for k, v in changed.items() if k.endswith("weight") or "running" in k),
            f"unchanged after training: {[k for k, v in changed.items() if not v]}")
    return skipped, changed


def check_round_trip(trainer, make_resumed, data) -> None:
    """Save ``trainer`` as "latest" and restore it into a fresh Trainer made
    with resume="latest": the parameters, the buffers and the optimizer
    state come back exactly."""
    trainer.save("latest")
    again = make_resumed()
    with contextlib.redirect_stdout(sys.stderr):
        again.fit(data, epochs=0)  # makes the optimizer and restores the checkpoint; runs no epoch
    for k, v in trainer.model.state_dict().items():
        require(torch.equal(v, again.model.state_dict()[k]), f"round trip: {k}")
    saved, loaded = trainer.optimizer.state_dict(), again.optimizer.state_dict()
    for i, st in saved["state"].items():
        for key, v in st.items():
            require(torch.equal(v.cpu(), loaded["state"][i][key].cpu()), f"round trip: optimizer state {i}.{key}")
    again.close()


def train_data():
    """Phase 16's data: one epoch of TRAIN_STEPS batches of SyntheticModelNet40."""
    from learning3d_tpu_torch.data import ClassificationData, SyntheticModelNet40

    return ClassificationData(SyntheticModelNet40(num_points=N, size=TRAIN_STEPS * B))


def train_config(ckpt):
    """Phase 16's configuration: bench.py's training step, Adam, augmentation on."""
    from learning3d_tpu_torch.train import TrainConfig

    return TrainConfig(exp_name="chip_smoke_train", batch_size=B, num_points=N, optimizer="adam", lr=TRAIN_LR,
                       epochs=1, augment=True, ckpt_dir=ckpt)


def phase_train(rng) -> dict:
    import dataclasses
    import tempfile

    from learning3d_tpu_torch.data import batch_iterator, to_device
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.models import Classifier, PointNet
    from learning3d_tpu_torch.train import Trainer
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    state = random_nnx_state(rng, EMB, CLASSES)

    def build(dtype):
        model = Classifier(PointNet(emb_dims=EMB, use_bn=True, dtype=dtype), CLASSES, dtype=dtype,
                           dropout_generator=torch.Generator(device="cuda").manual_seed(SEED))
        return load_nnx_state(model, state)

    data = train_data()
    kinds = {"bf16": torch.bfloat16, "f32": None}
    with tempfile.TemporaryDirectory() as ckpt:
        cfg = train_config(ckpt)
        trainer = Trainer(cfg, build(torch.bfloat16))
        before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # the Trainer's epoch line
            trainer.fit(data)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {k: LAUNCHES[k] for k in ("pool_stats_pallas", "pool_bwd_pallas")}
        require(all(v == TRAIN_STEPS for v in launches.values()), f"K3/K4 launches {launches} for {TRAIN_STEPS} steps")
        epoch = trainer.history[-1]
        skipped, changed = check_trained(trainer, before)

        batch = to_device(next(batch_iterator(data, B, seed=SEED)), "cuda")
        agreement = {}
        for kind, dtype in kinds.items():
            agreement[kind] = step_agreement(lambda: Trainer(cfg, build(dtype)), batch, STEP_TOL[kind], plain_poolgrad,
                                             what=f"train step {kind}")

        trained = trained_cls_steps(cfg, batch)
        check_round_trip(trainer, lambda: Trainer(dataclasses.replace(cfg, resume="latest"), build(torch.bfloat16)),
                         data)
        timing = time_train_step(trainer, batch)
        trainer.close()
    # fit_s includes set-up (torch._dynamo, which the first optimizer needs,
    # is imported beside the build); the epoch's clouds/s includes the host's making of
    # the synthetic clouds, which the prefetch thread overlaps with the steps
    result = {"launches": launches, "train_loss": epoch["train_loss"], "train_accuracy": epoch["train_accuracy"],
              "fit_s": fit_s, "epoch_s": epoch["seconds"], "epoch_clouds_per_s": TRAIN_STEPS * B / epoch["seconds"],
              **timing}
    emit("train", config={"model": "Classifier(PointNet(1024, use_bn=True)) bf16", "B": B, "N": N, "optimizer": "adam",
                          "lr": TRAIN_LR, "augment": True, "steps": TRAIN_STEPS},
         dataset=data.data_class.version_tag(), skipped_steps=skipped, tensors_changed=sum(changed.values()),
         tensors=len(changed), step_vs_plain={k: {"tolerance": STEP_TOL[k], **v} for k, v in agreement.items()},
         trained=trained, roundtrip="exact", **result)
    return result


def trained_cls_steps(cfg, batch) -> dict:
    """Phase 16's step check on the trained r4_pointnet_cls (the port
    checkpoint of phase 47) in bf16 and f32: the step on K3/K4 against the
    step on their plain versions within STEP_TOL with the control
    k3_misplaced outside it, and (reported) the plain step with K3's sums
    exact (``plain_f64_sums``) against the plain step: how far the rounding
    of the Gram matrix alone moves the trained step."""
    from learning3d_tpu_torch.models import Classifier, PointNet
    from learning3d_tpu_torch.train import Trainer

    t0 = time.perf_counter()
    state = torch.load(TRAINED / TRAINED_CLS / "best" / "model.pt", map_location="cpu", weights_only=True)

    def build(dtype):
        model = Classifier(PointNet(emb_dims=EMB, use_bn=True, dtype=dtype), CLASSES, dtype=dtype,
                           dropout_generator=torch.Generator(device="cuda").manual_seed(SEED))
        model.load_state_dict(state)
        return model

    out = {}
    for kind, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        make = functools.partial(lambda d: Trainer(cfg, build(d)), dtype)
        worst = step_agreement(make, batch, STEP_TOL[kind], plain_poolgrad, what=f"trained train step {kind}",
                               control=k3_misplaced)
        runs = step_runs(make, batch, (plain_poolgrad, plain_f64_sums))
        exact, _ = step_differences(runs[1], runs[0], STEP_TOL[kind], ZERO_GRADIENT_BIASES, NOISE_TOL)
        out[kind] = {"tolerance": STEP_TOL[kind], **worst,
                     "f64_sums_vs_plain": {k: exact[k] for k in ("loss", "grad", "grad_tensor", "zero_gradient_bias",
                                                                 "running")}}
    return {"release": TRAINED_CLS, "control": "k3_misplaced", "seconds": time.perf_counter() - t0, **out}


def phase_train_trained_cls() -> dict:
    """Phase 16's trained-weight step checks alone, on its data and
    configuration (``tools/smoke_phases.py``; chip_smoke.py runs them inside
    phase 16)."""
    import tempfile

    from learning3d_tpu_torch.data import batch_iterator, to_device

    batch = to_device(next(batch_iterator(train_data(), B, seed=SEED)), "cuda")
    with tempfile.TemporaryDirectory() as ckpt:
        trained = trained_cls_steps(train_config(ckpt), batch)
    emit("train_trained_cls", trained=trained)
    return trained


def library_edges(x, k):
    """Yardstick only, never used by the port: the edge features by an eager
    chain of torch.cdist, torch.topk over the distances and a gather, with
    the center beside each neighbor."""
    idx = torch.topk(torch.cdist(x, x), k, dim=-1, largest=False).indices
    B, n, _ = x.shape
    nbr = torch.gather(x, 1, idx.reshape(B, -1, 1).expand(-1, -1, 3)).reshape(B, n, k, 3)
    return torch.cat([nbr, x[:, :, None].expand(nbr.shape)], dim=-1)


def k7_bound(x, k) -> tuple[float, str]:
    """K7's bound: B N^2 distances of 8 f32 instructions each (none fused)
    and one comparison a distance to select (on the CUDA cores); x read
    once, the (B, N, k, 6) edge tensor written once."""
    B, n, _ = x.shape
    return bound(0.0, 4 * B * n * 3 + 4 * B * n * k * 6, f32_ops=9.0 * B * n * n)


def phase_kernel_k7(rng) -> dict:
    from learning3d_tpu_torch.kernels.edgeconv import edge_features, edge_features_reference

    cases = {
        "full": (rng.normal(size=(DCP_B, DCP_N, 3)).astype(np.float32), DCP_K),
        "ties": (lattice_cloud(rng, 2, 1000), DCP_K),
        "ragged": (rng.normal(size=(3, 1000, 3)).astype(np.float32), DCP_K),
        "k40": (rng.normal(size=(4, DCP_N, 3)).astype(np.float32), 40),
    }
    # past 32 the selection keeps a list of 64 keys a row: lattices with
    # exact ties at the k-th neighbor there, drawn from a generator of their
    # own so that the later phases keep their data
    own = np.random.default_rng(SEED + 7)
    cases.update({"ties_k33": (lattice_cloud(own, 2, 1000), 33), "ties_k64": (lattice_cloud(own, 2, 1000), 64)})
    checked = {}
    with torch.inference_mode():
        for name, (x_np, k) in cases.items():
            x = torch.from_numpy(x_np).cuda()
            # distinct points: equal neighbor coordinates are equal indices
            require(all(torch.unique(c, dim=0).shape[0] == x.shape[1] for c in x), f"K7 ({name}): repeated points")
            edges = edge_features(x, k)
            want_edges = edge_features_reference(x, k)
            torch.cuda.synchronize()
            require(torch.equal(edges, want_edges), f"K7 vs plain ({name}): edge features differ")
            checked[name] = {"B": x.shape[0], "N": x.shape[1], "k": k}
        x = torch.from_numpy(cases["full"][0]).cuda()
        k_ms = cuda_ms(lambda: edge_features(x, DCP_K))
        p_ms = cuda_ms(lambda: edge_features_reference(x, DCP_K), reps=3, warmup=1)
        l_ms = cuda_ms(lambda: library_edges(x, DCP_K))
    bound_ms, bound_by = k7_bound(x, DCP_K)
    result = {"max_abs_err": 0.0, "max_rel_err": 0.0, "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
              "bound_ms": bound_ms, "bound_by": bound_by}
    emit("kernel", name="knn_neighbors_pallas", tolerance="edge features bit-equal (distinct points, so the same neighbor indices)",
         cases=checked, shape={"B": DCP_B, "N": DCP_N, "k": DCP_K, "out": "(B, N, k, 6) edge features"},
         library="eager torch.cdist + torch.topk + gather, yardstick only", **result)
    return result


def phase_train_dcp(rng) -> dict:
    import dataclasses
    import tempfile

    from learning3d_tpu_torch.data import RegistrationData, SyntheticModelNet40, batch_iterator, to_device
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.models import DCP, DGCNN
    from learning3d_tpu_torch.train import TrainConfig, Trainer
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    state = random_dcp_state(rng, DCP_EMB)

    def build():
        return load_nnx_state(DCP(DGCNN(emb_dims=DCP_EMB, k=DCP_K)), state)

    data = RegistrationData("DCP", SyntheticModelNet40(num_points=DCP_N, size=TRAIN_DCP_STEPS * DCP_B))
    test_data = RegistrationData("DCP", SyntheticModelNet40(num_points=DCP_N, size=DCP_B, train=False))
    with tempfile.TemporaryDirectory() as ckpt:
        cfg = TrainConfig(exp_name="chip_smoke_train_dcp", task="dcp", batch_size=DCP_B, num_points=DCP_N,
                          optimizer="adam", lr=TRAIN_LR, epochs=1, best_metric="rot_deg", ckpt_dir=ckpt)
        trainer = Trainer(cfg, build())
        before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # the Trainer's epoch line
            trainer.fit(data, test_data)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        forwards = TRAIN_DCP_STEPS + len(test_data) // DCP_B
        require(launches["knn_neighbors_pallas"] == 2 * forwards,
                f"K7 launched {launches['knn_neighbors_pallas']} times in {forwards} forwards (want 2 each)")
        require(launches["attention_pallas"] == 7 * forwards,
                f"K6 launched {launches['attention_pallas']} times in {forwards} forwards (want 7 each)")
        require(launches["dgcnn_encode_fused"] == 0, "K5 launched on the f32 path")
        epoch = trainer.history[-1]
        skipped, changed = check_trained(trainer, before)
        require(all(np.isfinite(epoch[k]) for k in ("test_loss", "test_rot_deg", "test_trans")),
                f"eval pass: {epoch}")

        batch = to_device(next(batch_iterator(data, DCP_B, seed=SEED)), "cuda")
        agreement = step_agreement(lambda: Trainer(cfg, build()), batch, DCP_STEP_TOL, plain_versions,
                                   DCP_ZERO_GRADIENT_BIASES, DCP_NOISE_TOL, what="DCP train step",
                                   control=k6_bf16_output)
        check_round_trip(trainer, lambda: Trainer(dataclasses.replace(cfg, resume="latest"), build()), data)
        trainer.model.train()  # fit ended on the eval pass
        torch.cuda.reset_peak_memory_stats()
        timing = time_train_step(trainer, batch, unit="pairs")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        trainer.close()
    # fit_s includes the eval pass and the best checkpoint's save; the
    # epoch's pairs/s includes the host's making of the synthetic clouds and
    # pairs, which the prefetch thread overlaps with the steps
    result = {"launches": {k: launches[k] for k in ("knn_neighbors_pallas", "attention_pallas")},
              "train_loss": epoch["train_loss"], "train_rot_deg": epoch["train_rot_deg"],
              "test_rot_deg": epoch["test_rot_deg"], "test_trans": epoch["test_trans"], "fit_s": fit_s,
              "epoch_s": epoch["seconds"], "epoch_pairs_per_s": TRAIN_DCP_STEPS * DCP_B / epoch["seconds"],
              "peak_memory_gib": peak_gib, **timing}
    emit("train_dcp", config={"model": "DCP(DGCNN(512, k=20)) f32, transformer pointer, SVD head", "B": DCP_B,
                              "N": DCP_N, "optimizer": "adam", "lr": TRAIN_LR, "steps": TRAIN_DCP_STEPS,
                              "eval_pairs": len(test_data)},
         dataset=f"RegistrationData(DCP) over {data.data_class.version_tag()}", skipped_steps=skipped,
         tensors_changed=sum(changed.values()), tensors=len(changed),
         step_vs_plain={"tolerance": DCP_STEP_TOL, "zero_gradient_bias_tolerance": DCP_NOISE_TOL, **agreement},
         roundtrip="exact", **result)
    return result


IPC_B, IPC_N, IPC_EMB, IPC_STARTS = 32, 1024, 1024, 8
IPC_REQUESTS = (32, 10, 70)
IPC_TRAIN_B, IPC_TRAIN_STEPS = 20, 4  # examples/train_pcrnet.py's batch
PCN_B, PCN_N, PCN_EMB, PCN_COARSE, PCN_TRAIN_STEPS = 32, 1024, 1024, 1024, 4
SFU_BOUND_EXPS_PER_PAIR_LEVEL = 2  # the TPU kernel's two passes a level, one exponential a pair each
# The TPU kernel's two passes a level take 43 f32 operations a pair (11 in
# phase A: d^2, the level, a product and a sum; 32 in phase B/C: d^2, the
# level, sumr, W, C, the cost, W / C, and the row and column sums of W, W / C
# and W / C times the coordinates), each product and each sum on its own:
# the two squared distances are 16 instructions that cannot fuse (written
# __fsub_rn, __fmul_rn, __fadd_rn); the other 27 are counted as flops, an
# FMA as two (csrc/emd.cu's header states the same bound)
EMD_F32_INSTRUCTIONS_PER_PAIR_LEVEL = 16
EMD_F32_FLOPS_PER_PAIR_LEVEL = 27
EMD_LEVELS = 10
# bf16 iPCRNet on the kernels against the same model on the plain versions
# (K1's oracle, K12's plain version) at one refinement step, where K1 runs
# for the template and the source: max |k - p| <= IPCRNET_TOL * max |p| for
# est_T and per item |k - p| <= IPCRNET_TOL * p for the Chamfer score of
# every start. K1 and its plain version sum in another order, so a pooled
# feature can round to the neighbouring bf16 value (2^-8 of it), which the
# MLP carries into the pose. Past one step the random-weight model is
# chaotic (each step's pose is a random rotation, and K1 rounds the moved
# source to bf16 again: one f32 ulp of the source moved est_R by up to 11%
# after 8 steps on the CPU, tests/test_torch_pcrnet.py), so there the gate
# is K12 inside the selection: the 8-step candidates scored again on K12's
# plain version give the same scores bit for bit, so the same starts
IPCRNET_TOL = 5e-2
# bf16 iPCRNet builds each step's rotation in bf16 (qnormalize, quat2mat, as
# the JAX package does), so a step is a rotation only to bf16 rounding: an
# entry near 1 rounds by up to 2^-8, a row's norm by a few of those; allowing
# 2^-6 a step, the composed est_R of n steps has |R R^T - I| <=
# (1 + 2^-6)^(2n) - 1 (0.28 at n = 8). f32 est_R is held to ROT_TOL
IPC_BF16_STEP_ROT = 2.0**-6


def bf16_rotation_tol(steps: int) -> float:
    return (1.0 + IPC_BF16_STEP_ROT) ** (2 * steps) - 1.0


def rotation_error(R) -> float:
    """max |R R^T - I| and |det R - 1| over a batch of 3x3 matrices."""
    R = np.asarray(R, np.float64)
    return max(float(np.abs(R @ np.swapaxes(R, -1, -2) - np.eye(3)).max()),
               float(np.abs(np.linalg.det(R) - 1.0).max()))
# one f32 train step of iPCRNet or PCN on K12 against the same step on its
# plain version, per-tensor relative error: K12 is bit-equal, so the
# forward is the same; the Chamfer backward's scatter-adds add with atomics
# in another order on each run (f32 rounding, ~1e-7 of a value)
CHAMFER_STEP_TOL = 1e-4
# K13 against its plain version: the cost per item to rtol EMD_COST_TOL, g1
# and g2 to a mean relative error below EMD_GRAD_TOL (the JAX package's own
# bound for its kernel against _emd_fwd_impl): ratioL divides by sums that
# vanish at the sharpest levels, so a sum in another order can move one
# point's gradient a lot while the cost barely moves
EMD_COST_TOL, EMD_GRAD_TOL = 1e-4, 5e-2


def random_linear(flat, rng, prefix, i, o):
    flat[f"{prefix}.kernel"] = rng.normal(0.0, i**-0.5, (i, o)).astype(np.float32)
    flat[f"{prefix}.bias"] = rng.normal(0.0, 0.1, (o,)).astype(np.float32)


def random_ipcrnet_state(rng, emb: int = IPC_EMB) -> dict:
    """A flat nnx state of iPCRNet(PointNet(emb, use_bn=False)) with
    numpy-seeded weights."""
    flat = {}
    dims = [3, 64, 64, 64, 128, emb]
    for k, (i, o) in enumerate(zip(dims[:-1], dims[1:])):
        random_linear(flat, rng, f"feature_model.convs.{k}", i, o)
    dims = [2 * emb, 1024, 1024, 512, 512, 256]
    for k, (i, o) in enumerate(zip(dims[:-1], dims[1:])):
        random_linear(flat, rng, f"linears.{k}", i, o)
    random_linear(flat, rng, "head", 256, 7)
    return flat


def random_pcn_state(rng, emb: int = PCN_EMB, num_coarse: int = PCN_COARSE, detailed: bool = False) -> dict:
    """A flat nnx state of PCN(emb, num_coarse) with numpy-seeded weights,
    the folding decoder's too if ``detailed``."""
    flat = {}
    for name, i, o in (("conv1", 3, 128), ("conv2", 128, 256), ("conv3", 512, 512), ("conv4", 512, emb),
                       ("linear1", emb, 1024), ("linear2", 1024, 1024), ("linear3", 1024, 3 * num_coarse)):
        random_linear(flat, rng, name, i, o)
    if detailed:
        for name, i, o in (("conv5", emb + 5, 512), ("conv6", 512, 512), ("conv7", 512, 3)):
            random_linear(flat, rng, name, i, o)
    return flat


def library_nn(x, y):
    """Yardstick only, never used by the port: torch.cdist, then the
    minimum over the other cloud with its index."""
    return torch.min(torch.cdist(x, y), dim=-1)


def k12_bound(b, n, m) -> tuple[float, str]:
    """K12's bound: B N M distances of 8 f32 instructions each (none fused)
    and one comparison a distance (on the CUDA cores); x and y read once,
    the (B, N) distances and indices written once."""
    return bound(0.0, 4 * b * (n + m) * 3 + 8 * b * n, f32_ops=9.0 * b * n * m)


def phase_kernel_k12(rng) -> dict:
    from learning3d_tpu_torch.kernels.chamfer import _nn_oneway_reference, nn_oneway

    def normal(b, n):
        return rng.normal(size=(b, n, 3)).astype(np.float32)

    cases = {
        "multistart": (normal(IPC_STARTS * IPC_B, IPC_N), normal(IPC_STARTS * IPC_B, IPC_N)),
        "fine_points_to_fine": (normal(PCN_B, PCN_N), normal(PCN_B, 16 * PCN_COARSE)),
        "ragged": (normal(3, 1000), normal(3, 136)),
        "ties": (lattice_cloud(rng, 2, 1000), lattice_cloud(rng, 2, 700)),
    }
    cases["fine_to_points"] = cases["fine_points_to_fine"][::-1]
    checked = {}
    with torch.inference_mode():
        for name, (x_np, y_np) in cases.items():
            x, y = torch.from_numpy(x_np).cuda(), torch.from_numpy(y_np).cuda()
            d, i = nn_oneway(x, y)
            want_d, want_i = _nn_oneway_reference(x, y)
            torch.cuda.synchronize()
            require(torch.equal(d, want_d), f"K12 vs plain ({name}): distances differ")
            require(torch.equal(i, want_i), f"K12 vs plain ({name}): indices differ")
            checked[name] = {"B": x.shape[0], "N": x.shape[1], "M": y.shape[1]}
            del want_d, want_i
        x, y = (torch.from_numpy(a).cuda() for a in cases["multistart"])
        k_ms = cuda_ms(lambda: nn_oneway(x, y))
        p_ms = cuda_ms(lambda: _nn_oneway_reference(x, y), reps=3, warmup=1)
        l_ms = cuda_ms(lambda: library_nn(x, y), reps=5)
        xf, yf = (torch.from_numpy(a).cuda() for a in cases["fine_points_to_fine"])
        fine_ms = {"points_to_fine": cuda_ms(lambda: nn_oneway(xf, yf), reps=5),
                   "fine_to_points": cuda_ms(lambda: nn_oneway(yf, xf), reps=5)}
    bound_ms, bound_by = k12_bound(*x.shape[:2], y.shape[1])
    fine_bound = k12_bound(PCN_B, PCN_N, 16 * PCN_COARSE)[0]
    result = {"max_abs_err": 0.0, "max_rel_err": 0.0, "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
              "bound_ms": bound_ms, "bound_by": bound_by}
    emit("kernel_k12", name="_nn_oneway_pallas", tolerance="distances bit-equal, indices equal", cases=checked,
         shape={"B": x.shape[0], "N": x.shape[1], "M": y.shape[1], "note": "multistart: 8 starts x 32 pairs"},
         fine_kernel_ms=fine_ms, fine_bound_ms=fine_bound,
         library="torch.cdist + torch.min over the other cloud, yardstick only", **result)
    return result


def k13_bound(b, n, m) -> tuple[float, str]:
    """K13's bound: 2 * 10 * B N M exponentials on the SFU (the TPU
    kernel's two passes a level) or the f32 arithmetic a pair and level on
    the CUDA cores (16 instructions and 27 flops), whichever takes longer;
    x and y read once, cost, g1 and g2 written once."""
    pairs = float(b) * n * m * EMD_LEVELS
    exp_s = SFU_BOUND_EXPS_PER_PAIR_LEVEL * pairs / SFU_EXP_PER_S
    f32_s = pairs * (EMD_F32_INSTRUCTIONS_PER_PAIR_LEVEL / PEAK_F32_OPS + EMD_F32_FLOPS_PER_PAIR_LEVEL / PEAK_F32_FLOPS)
    bytes_s = (4 * b * (n + m) * 3 * 2 + 4 * b) / PEAK_BYTES
    return 1e3 * max(exp_s, f32_s, bytes_s), "operations" if max(exp_s, f32_s) >= bytes_s else "bytes"


def emd_errors(got, want, what) -> dict:
    (c, g1, g2), (wc, wg1, wg2) = got, want
    require(all(bool(torch.isfinite(t).all()) for t in (c, g1, g2)), f"K13 {what}: outputs finite")
    cost_rel = ((c - wc).abs() / wc.abs()).max().item()
    require(cost_rel <= EMD_COST_TOL, f"K13 {what}: cost rel err {cost_rel} > {EMD_COST_TOL}")
    grads = {}
    for key, g, w in (("g1", g1, wg1), ("g2", g2, wg2)):
        require(g.shape == w.shape, f"K13 {what}: {key} shape")
        grads[key] = ((g - w).abs().mean() / w.abs().mean()).item()
        require(grads[key] < EMD_GRAD_TOL, f"K13 {what}: {key} mean rel err {grads[key]} >= {EMD_GRAD_TOL}")
    return {"abs": (c - wc).abs().max().item(), "rel": cost_rel, "g1_mean_rel": grads["g1"],
            "g2_mean_rel": grads["g2"]}


K13_SHAPES = {"pcn": (PCN_B, PCN_N, PCN_COARSE), "n_gt_m": (3, 1000, 300), "n_lt_m": (2, 250, 1000),
              "b1": (1, 1024, 1024), "max": (1, 4096, 4096), "ragged": (5, 1001, 777)}


def device_launches(fn) -> dict:
    """{kernel name: launches} of one call of ``fn`` under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    def name(key):  # "void (anonymous namespace)::emd_cluster_kernel<128, ...>(float const*, ...)" -> the name
        found = re.search(r"(\w+)(?:<[^()]*>)?\(", key)
        return found.group(1) if found else key

    return {name(e.key): e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and getattr(e, "self_device_time_total", 0.0) > 0}


def phase_kernel_k13(rng) -> dict:
    from learning3d_tpu_torch.kernels.emd import _emd_fwd_reference, emd_kernel

    errs, times = {}, {}
    with torch.inference_mode():
        for name, (b, n, m) in K13_SHAPES.items():
            x, y = (torch.from_numpy(rng.normal(size=(b, k, 3)).astype(np.float32)).cuda() for k in (n, m))
            got = emd_kernel(x, y)
            want = _emd_fwd_reference(x, y)
            torch.cuda.synchronize()
            errs[name] = emd_errors(got, want, name)
            if name == "pcn":
                full = (x, y)
            else:
                times[name] = cuda_ms(lambda: emd_kernel(x, y), reps=3, runs=1)
            del want
        k_ms = cuda_ms(lambda: emd_kernel(*full), reps=5)
        p_ms = cuda_ms(lambda: _emd_fwd_reference(*full), reps=2, warmup=1)
        per_call = device_launches(lambda: emd_kernel(*full))
    require(sum(per_call.values()) == 1, f"K13: device launches a call {per_call}, want one")
    bound_ms, bound_by = k13_bound(PCN_B, PCN_N, PCN_COARSE)
    result = {"max_abs_err": max(e["abs"] for e in errs.values()), "max_rel_err": max(e["rel"] for e in errs.values()),
              "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
    emit("kernel_k13", name="_emd_fwd_pallas",
         tolerance=f"cost rel <= {EMD_COST_TOL}; g1, g2 mean rel < {EMD_GRAD_TOL}", errors=errs,
         shape={"B": PCN_B, "N": PCN_N, "M": PCN_COARSE, "note": "PCN's coarse EMD loss"},
         shapes={k: dict(zip("BNM", v)) for k, v in K13_SHAPES.items()}, kernel_ms_at=times,
         bounds_at={k: k13_bound(*v)[0] for k, v in K13_SHAPES.items()}, device_launches_per_call=per_call,
         library="none: no one PyTorch call computes approxmatch", **result)
    return result


def ipcrnet_agreement(model, template, source, rots, what) -> dict:
    """The gates of bf16 iPCRNet serving against the plain versions (see
    IPCRNET_TOL): the multistart candidates at the model's own step count
    rescored on K12's plain version (bit-equal scores), then the forward and
    every start's est_T and score at one step, kernels against plain; the
    picked start must agree wherever the plain run's two best scores lie
    more than twice the tolerance apart."""
    from learning3d_tpu_torch.serve import chamfer_scores, multistart_scores

    total, scores = multistart_scores(model, template, source, rots)
    with plain_versions():
        rescored = chamfer_scores(total, template, source)
    require(torch.equal(rescored, scores), f"{what}: K12's scores differ from its plain version's")
    iters = model.default_iterations
    model.default_iterations = 1
    try:
        first, (k_total, k_scores) = model(template, source), multistart_scores(model, template, source, rots)
        with plain_versions():
            plain, (p_total, p_scores) = model(template, source), multistart_scores(model, template, source, rots)
    finally:
        model.default_iterations = iters
    est_err = max((k - p).abs().max().item() / p.abs().max().item()
                  for k, p in ((first["est_T"], plain["est_T"]), (k_total, p_total)))
    require(est_err <= IPCRNET_TOL, f"{what}: one-step est_T rel err {est_err} > {IPCRNET_TOL}")
    score_err = ((k_scores - p_scores).abs() / p_scores).max().item()
    require(score_err <= IPCRNET_TOL, f"{what}: one-step chamfer score rel err {score_err} > {IPCRNET_TOL}")
    best2 = torch.topk(p_scores, 2, dim=0, largest=False).values
    apart = (best2[1] - best2[0]) > 2 * IPCRNET_TOL * best2[0]
    pick, plain_pick = k_scores.argmin(0), p_scores.argmin(0)
    require(bool((pick == plain_pick)[apart].all()), f"{what}: start_idx differs where the scores lie apart")
    return {"rescored_bit_equal": True, "one_step_est_T_rel": est_err, "one_step_chamfer_rel": score_err,
            "starts_apart": int(apart.sum()), "starts_differing": int((pick != plain_pick).sum()),
            "of": int(pick.numel())}


def phase_serve_ipcrnet(rng) -> dict:
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.models import PointNet, iPCRNet
    from learning3d_tpu_torch.serve import InferenceEngine, multistart_register, multistart_scores, rotation_starts
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    bf16 = torch.bfloat16
    model = load_nnx_state(iPCRNet(PointNet(emb_dims=IPC_EMB, dtype=bf16), dtype=bf16),
                           random_ipcrnet_state(rng)).eval()
    engine = InferenceEngine(model, batch_size=IPC_B)
    requests = [(rng.normal(size=(n, IPC_N, 3)).astype(np.float32), rng.normal(size=(n, IPC_N, 3)).astype(np.float32))
                for n in IPC_REQUESTS]
    chunks = sum(-(-n // IPC_B) for n in IPC_REQUESTS)
    iters = model.default_iterations
    reset_launches()
    outs = [engine(t, s) for t, s in requests]
    torch.cuda.synchronize()
    launches = LAUNCHES["pointnet_pooled_kernel"]
    require(launches == (1 + iters) * chunks, f"K1 launched {launches} times for {chunks} chunks (want 9 a chunk)")
    rot_err, rot_tol = 0.0, bf16_rotation_tol(iters)
    for (t, _), out in zip(requests, outs):
        require(out["est_T"].shape == (t.shape[0], 4, 4) and out["r"].shape == (t.shape[0], IPC_EMB), "result shapes")
        for key, val in out.items():
            require(bool(np.isfinite(val).all()), f"every {key} finite")
        rot_err = max(rot_err, rotation_error(out["est_R"]))
    require(rot_err <= rot_tol, f"est_R not a rotation to bf16 rounding: {rot_err} > {rot_tol}")

    rots = rotation_starts(IPC_STARTS)
    t_dev, s_dev = (torch.from_numpy(a[:IPC_B]).cuda() for a in requests[0])
    with torch.inference_mode():
        reset_launches()
        ms = multistart_register(model, t_dev, s_dev, rots)
        torch.cuda.synchronize()
        ms_launches = {k: LAUNCHES[k] for k in ("pointnet_pooled_kernel", "_nn_oneway_pallas")}
        require(ms_launches == {"pointnet_pooled_kernel": 1 + iters, "_nn_oneway_pallas": 2},
                f"multistart launches {ms_launches} (want K1 9, K12 2)")
        require(all(bool(torch.isfinite(v.float()).all()) for v in ms.values()), "multistart outputs finite")
        total, scores = multistart_scores(model, t_dev, s_dev, rots)
        require(torch.equal(scores.min(0).values, ms["chamfer"]) and torch.equal(scores.argmin(0), ms["start_idx"])
                and torch.equal(total[ms["start_idx"], torch.arange(IPC_B, device="cuda")], ms["est_T"]),
                "multistart's result is its best start's")
        require(rotation_error(ms["est_T"][:, :3, :3].cpu()) <= rot_tol, "multistart est_T's rotation")
        agree = ipcrnet_agreement(model, t_dev, s_dev, rots, "serve_ipcrnet")
        model_ms = cuda_ms(lambda: model(t_dev, s_dev), reps=5)
        ms_ms = cuda_ms(lambda: multistart_register(model, t_dev, s_dev, rots), reps=3, warmup=1)
        with plain_versions():
            plain_model_ms = cuda_ms(lambda: model(t_dev, s_dev), reps=3, warmup=1)
    engine(*requests[0])
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine(*requests[0])
    host_s = (time.perf_counter() - t0) / reps
    result = {"launches": launches, "multistart_launches": ms_launches}
    emit("serve_ipcrnet", config={"model": "iPCRNet(PointNet(1024, use_bn=False)) bf16 eval, 8 iterations",
                                  "B": IPC_B, "N": IPC_N, "starts": IPC_STARTS},
         requests=list(IPC_REQUESTS), chunks=chunks, launches=launches, multistart_launches=ms_launches,
         tolerance=f"one step: est_T, chamfer scores <= {IPCRNET_TOL} (relative); 8 steps: K12 rescoring bit-equal",
         agree=agree,
         rotation={"max_RRt_minus_I_or_det": rot_err, "tolerance": rot_tol}, pairs_per_s=IPC_B / host_s,
         engine_ms=1e3 * host_s,
         model_ms=model_ms, plain_model_ms=plain_model_ms, multistart_ms=ms_ms,
         multistart_pairs_per_s=IPC_B / (ms_ms * 1e-3),
         start_idx_counts=np.bincount(ms["start_idx"].cpu().numpy(), minlength=IPC_STARTS).tolist())
    return result


def phase_train_ipcrnet(rng) -> dict:
    import tempfile

    from learning3d_tpu_torch.data import RegistrationData, SyntheticModelNet40, batch_iterator, to_device
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.models import PointNet, iPCRNet
    from learning3d_tpu_torch.train import TrainConfig, Trainer
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    state = random_ipcrnet_state(rng)

    def build():
        return load_nnx_state(iPCRNet(PointNet(emb_dims=IPC_EMB)), state)

    data = RegistrationData("iPCRNet", SyntheticModelNet40(num_points=IPC_N, size=IPC_TRAIN_STEPS * IPC_TRAIN_B))
    with tempfile.TemporaryDirectory() as ckpt:
        cfg = TrainConfig(exp_name="chip_smoke_train_ipcrnet", task="ipcrnet", batch_size=IPC_TRAIN_B,
                          num_points=IPC_N, optimizer="adam", lr=TRAIN_LR, epochs=1, ckpt_dir=ckpt)
        trainer = Trainer(cfg, build())
        before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        reset_launches()
        with contextlib.redirect_stdout(sys.stderr):  # the Trainer's epoch line
            trainer.fit(data)
        torch.cuda.synchronize()
        launches = LAUNCHES["_nn_oneway_pallas"]
        require(launches == 2 * IPC_TRAIN_STEPS, f"K12 launched {launches} times in {IPC_TRAIN_STEPS} steps")
        require(LAUNCHES["pointnet_pooled_kernel"] == 0, "K1 launched on the f32 train path")
        epoch = trainer.history[-1]
        skipped, changed = check_trained(trainer, before)
        require(all(np.isfinite(epoch[k]) for k in ("train_rot_deg", "train_trans")), f"train metrics: {epoch}")
        batch = to_device(next(batch_iterator(data, IPC_TRAIN_B, seed=SEED)), "cuda")
        with torch.no_grad():
            f32_rot_err = rotation_error(trainer.model.eval()(*batch[:2])["est_R"].cpu())
        trainer.model.train()
        require(f32_rot_err <= ROT_TOL, f"f32 est_R not a rotation: {f32_rot_err}")
        agreement = step_agreement(lambda: Trainer(cfg, build()), batch, CHAMFER_STEP_TOL, plain_versions, (), 0.0,
                                   what="iPCRNet train step")
        timing = time_train_step(trainer, batch, unit="pairs")
        trainer.close()
    result = {"launches": launches, "train_loss": epoch["train_loss"], "train_rot_deg": epoch["train_rot_deg"],
              "epoch_s": epoch["seconds"], "f32_rotation_error": f32_rot_err, **timing}
    emit("train_ipcrnet", config={"model": "iPCRNet(PointNet(1024, use_bn=False)) f32, 8 iterations",
                                  "B": IPC_TRAIN_B, "N": IPC_N, "optimizer": "adam", "lr": TRAIN_LR,
                                  "steps": IPC_TRAIN_STEPS},
         dataset=f"RegistrationData(iPCRNet) over {data.data_class.version_tag()}", skipped_steps=skipped,
         tensors_changed=sum(changed.values()), tensors=len(changed),
         step_vs_plain={"tolerance": CHAMFER_STEP_TOL, **agreement}, **result)
    return result


def phase_train_pcn(rng) -> dict:
    import tempfile

    from learning3d_tpu_torch.data import ClassificationData, SyntheticModelNet40, batch_iterator, to_device
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.kernels.emd import _emd_fwd_reference
    from learning3d_tpu_torch.losses import emd_loss_mean
    from learning3d_tpu_torch.models import PCN
    from learning3d_tpu_torch.train import TrainConfig, Trainer
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    state = random_pcn_state(rng, detailed=True)
    coarse_state = {k: v for k, v in state.items() if not k.startswith(("conv5", "conv6", "conv7"))}

    def build(detailed=False):
        return load_nnx_state(PCN(emb_dims=PCN_EMB, num_coarse=PCN_COARSE, detailed_output=detailed),
                              state if detailed else coarse_state)

    data = ClassificationData(SyntheticModelNet40(num_points=PCN_N, size=PCN_TRAIN_STEPS * PCN_B))
    with tempfile.TemporaryDirectory() as ckpt:
        cfg = TrainConfig(exp_name="chip_smoke_train_pcn", task="pcn", batch_size=PCN_B, num_points=PCN_N,
                          optimizer="adam", lr=TRAIN_LR, epochs=1, ckpt_dir=ckpt)
        trainer = Trainer(cfg, build())
        before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        reset_launches()
        with contextlib.redirect_stdout(sys.stderr):  # the Trainer's epoch line
            trainer.fit(data)
        torch.cuda.synchronize()
        launches = {"coarse_fit": LAUNCHES["_nn_oneway_pallas"]}
        require(launches["coarse_fit"] == 2 * PCN_TRAIN_STEPS,
                f"K12 launched {launches['coarse_fit']} times in {PCN_TRAIN_STEPS} steps")
        epoch = trainer.history[-1]
        skipped, changed = check_trained(trainer, before)
        batch = to_device(next(batch_iterator(data, PCN_B, seed=SEED)), "cuda")
        agreement = {"coarse": step_agreement(lambda: Trainer(cfg, build()), batch, CHAMFER_STEP_TOL, plain_versions,
                                              (), 0.0, what="PCN train step")}
        timing = {"coarse": time_train_step(trainer, batch)}
        trainer.close()

        # one step of the detailed model: the fine Chamfer against 16384 points
        detailed = Trainer(cfg, build(detailed=True))
        detailed._ensure_optimizer(1)
        reset_launches()
        loss, aux = detailed.train_step(batch)
        torch.cuda.synchronize()
        launches["detailed_step"] = LAUNCHES["_nn_oneway_pallas"]
        require(launches["detailed_step"] == 4, f"K12 launched {launches['detailed_step']} times in a detailed step")
        require(np.isfinite(loss.item()) and all(np.isfinite(v.item()) for v in aux.values()),
                f"detailed step: {loss}, {aux}")
        require(int(detailed.skipped_steps) == 0, "detailed step skipped")
        agreement["detailed"] = step_agreement(lambda: Trainer(cfg, build(detailed=True)), batch, CHAMFER_STEP_TOL,
                                               plain_versions, (), 0.0, what="detailed PCN train step")
        torch.cuda.reset_peak_memory_stats()
        timing["detailed"] = time_train_step(detailed, batch, reps=3)
        timing["detailed"]["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        detailed.close()

    # the EMD loss on the coarse completion, forward and backward
    model = build()
    points = batch[0]
    emd = {}
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        reset_launches()
        coarse = model(points)["coarse_output"]
        coarse.retain_grad()
        with plain_versions() if plain else contextlib.nullcontext():
            loss = emd_loss_mean(points, coarse)
            loss.backward()
        torch.cuda.synchronize()
        emd["plain" if plain else "kernel"] = (loss.item(), coarse.grad.clone(), LAUNCHES["_emd_fwd_pallas"])
    (lk, gk, nk), (lp, gp, np_) = emd["kernel"], emd["plain"]
    require((nk, np_) == (1, 0), f"K13 launches {nk} (kernels), {np_} (plain) for one EMD loss")
    emd_rel = abs(lk - lp) / abs(lp)
    require(np.isfinite(lk) and emd_rel <= EMD_COST_TOL, f"EMD loss {lk} vs plain {lp}")
    grad_rel = ((gk - gp).abs().mean() / gp.abs().mean()).item()
    require(grad_rel < EMD_GRAD_TOL, f"EMD loss gradient mean rel err {grad_rel} >= {EMD_GRAD_TOL}")
    with torch.no_grad():
        coarse = model(points)["coarse_output"]
    emd_ms = cuda_ms(lambda: emd_loss_mean(points, coarse.detach().requires_grad_()).backward(), reps=5)
    launches["emd"] = nk
    result = {"launches": launches, "train_loss": epoch["train_loss"], "epoch_s": epoch["seconds"],
              "timing": timing, "emd_loss_ms": emd_ms}
    emit("train_pcn", config={"model": "PCN(emb 1024, num_coarse 1024) f32; detailed_output=True for one step",
                              "B": PCN_B, "N": PCN_N, "optimizer": "adam", "lr": TRAIN_LR,
                              "steps": PCN_TRAIN_STEPS},
         dataset=f"ClassificationData over {data.data_class.version_tag()}", skipped_steps=skipped,
         tensors_changed=sum(changed.values()), tensors=len(changed),
         step_vs_plain={"tolerance": CHAMFER_STEP_TOL, **agreement},
         emd={"loss": lk, "loss_rel_vs_plain": emd_rel, "grad_mean_rel_vs_plain": grad_rel,
              "tolerance": f"loss rel <= {EMD_COST_TOL}, gradient mean rel < {EMD_GRAD_TOL}"},
         **result)
    return result


# PRNet() as examples/train.py builds it: DGCNN emb 512, k 20, 512 keypoints
# of a 768-point partial source against a 1024-point template, 3 iterations,
# f32; served at B=32, trained at B=16 (examples/train_prnet.py)
PRNET_B, PRNET_TRAIN_B, PRNET_EMB, PRNET_K = 32, 16, 512, 20
PRNET_NS, PRNET_NT, PRNET_ITERS = 768, 1024, 3
PRNET_REQUESTS = (32, 10, 70)
PRNET_MS_PAIRS, PRNET_TRAIN_STEPS = 4, 4
# K8 launches a PRNet forward: 4 stages x (the template's pass + one source
# pass an iteration); K6 six a pointer call, one pointer call an iteration
K8_PER_FORWARD = 4 * (1 + PRNET_ITERS)
K6_PER_FORWARD = 6 * PRNET_ITERS
# one PRNet iteration on the kernels against the plain versions, max |k - p|
# <= PRNET_TOL * max |p| of est_T and transformed_source: K8 is bit-equal to
# its plain version, and K6 on f32 q, k, v writes f32 that differs from its
# plain version by the sum order only (<= 5.9e-4 of max, phase kernel K6);
# the pointer's residual moves the embeddings by that much, the softmax
# correspondences (temperature up to 100) and the Kabsch solver carry it
# into the pose. The control k6_bf16_output (K6's output rounded to bf16)
# must fail the limit. tools/torch_prnet_step_gaps.py (3 weight draws, B=32,
# the H100): kernels 2.4e-6 to 5.5e-6, control 4.6e-4 to 7.5e-3; this
# script's draw 1.3e-6 and 5.5e-4. The limit lies 18x above the kernels'
# largest and 4.6x below the control's smallest. Past one
# iteration the random-weight model composes poses from features that are
# discontinuous in the points (the top-k by norm, the feature-space kNN):
# there the flips and the gap are reported, not held
PRNET_TOL = 1e-4
# one PRNet train step on the kernels against the same step on the plain
# versions. K8 is bit-equal; K6 differs from its plain version by the sum
# order. tools/torch_prnet_step_gaps.py (3 weight draws, B=16, the H100):
# at one iteration the kernels' worst per-tensor gradient gap is 2.7e-4 to
# 3.4e-4, the control (K6's output rounded to bf16) 5.4e-3 to 0.157, so the
# one-iteration step is held to PRNET_STEP_TOL and the control must fail it.
# At three iterations the gradient is not a well-conditioned function of
# the inputs: moving the source by one f32 ulp moves the plain step's
# gradient by 2.6% to 580%, and the kernels' gap (5.1% to 9.7%) lies in that
# range; so does the loss's (kernels 4.7e-7 to 1.9e-5 in the tool's draws,
# 1.07e-4 on this script's first card run; one ulp 3.7e-5 to 5.6e-4). There
# the loss and gradient gaps of the kernels and of the one-ulp move are
# reported, not held. TemperatureNet's and the key projections' biases have
# no gradient in exact arithmetic (a train-mode BatchNorm or the softmax
# takes them out), held to PRNET_NOISE_TOL of their weight gradient
PRNET_STEP_TOL = 1e-3
PRNET_NOISE_TOL = 1e-3
PRNET_ZERO_GRADIENT_BIASES = tuple(f"temp_net.layers.{i}.bias" for i in range(3)) + tuple(
    f"attention.{layer}.{attn}.wk.bias" for layer, attn in (
        ("enc_layers.0", "self_attn"), ("dec_layers.0", "self_attn"), ("dec_layers.0", "cross_attn")))


def random_bn(flat, rng, prefix, c):
    flat[f"{prefix}.scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    flat[f"{prefix}.bias"] = rng.normal(0.0, 0.1, c).astype(np.float32)
    flat[f"{prefix}.mean"] = rng.normal(0.0, 0.2, c).astype(np.float32)
    flat[f"{prefix}.var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)


def random_prnet_state(rng, emb: int = PRNET_EMB) -> dict:
    """A flat nnx state of PRNet() (PRDGCNN, the transformer pointer,
    TemperatureNet, the SVD head's temperature) with numpy-seeded weights
    and non-trivial BatchNorm statistics."""
    flat = {k.replace("pointer.", "attention.", 1): v for k, v in random_dcp_state(rng, emb).items()
            if k.startswith("pointer.")}
    for k, (i, o) in enumerate([(6, 64), (128, 64), (128, 128), (256, 256), (512, emb)]):
        flat[f"emb_nn.convs.{k}.kernel"] = rng.normal(0.0, i**-0.5, (i, o)).astype(np.float32)
        random_bn(flat, rng, f"emb_nn.bns.{k}", o)
    for k, (i, o) in enumerate([(emb, 128), (128, 128), (128, 128)]):
        random_linear(flat, rng, f"temp_net.layers.{k}", i, o)
        random_bn(flat, rng, f"temp_net.bns.{k}", o)
    random_linear(flat, rng, "temp_net.head", 128, 1)
    flat["head.temperature"] = np.full((1,), 0.5, np.float32)
    return flat


def library_knn(q, p, k):
    """Yardstick only, never used by the port: torch.cdist (full f32, TF32
    off) and torch.topk of the smallest."""
    return torch.topk(torch.cdist(q, p), k, dim=-1, largest=False)


def k8_bound(q, p, k, same: bool) -> tuple[float, str]:
    """K8's bound: at C == 3, B S N distances of 8 f32 instructions and one
    comparison each; else 2 C instructions a pair for the cross term (a
    product and a sum a channel, none fused) and one comparison (the
    squared norms are 2 B (S + N) C more); on the CUDA cores.
    Bytes: the queries and the points read once (once for a self search),
    the (B, S, k) distances and indices written once."""
    B, S, C = q.shape
    n = p.shape[1]
    ops = 9.0 * B * S * n if C == 3 else (2.0 * C + 1.0) * B * S * n + 2.0 * C * B * (S + n)
    nbytes = 4 * (q.numel() + (0 if same else p.numel())) + 8 * B * S * k
    return bound(0.0, nbytes, f32_ops=ops)


def k8_cases(rng) -> dict:
    """name -> (queries, points, k) as device tensors: PRNet's stage shapes
    (B=16: xyz, 64 and 128 feature channels, the template's N=1024 and the
    source's N=768; self searches), a cross-cloud search (1024 queries among
    2048 points), a ragged one (777 queries among 1000 points, C=67), a
    lattice cloud with exact ties at the 20th neighbor, and near-duplicate
    features of large norm whose distances round below 0."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()

    cases = {}
    for c in (3, 64, 128):
        for n in (PRNET_NT, PRNET_NS):
            x = dev(rng.normal(size=(PRNET_TRAIN_B, n, c)))
            cases[f"C{c}_N{n}"] = (x, x, PRNET_K)
    cases["cross_cloud"] = (dev(rng.normal(size=(4, 1024, 3))), dev(rng.normal(size=(4, 2048, 3))), PRNET_K)
    cases["ragged"] = (dev(rng.normal(size=(3, 777, 67))), dev(rng.normal(size=(3, 1000, 67))), PRNET_K)
    x = dev(lattice_cloud(rng, 2, 1000))
    cases["ties"] = (x, x, PRNET_K)
    base = 100.0 + rng.normal(size=(2, 384, 32))
    x = dev(np.concatenate([base, base + 1e-4 * rng.normal(size=base.shape)], axis=1))
    cases["negative"] = (x, x, PRNET_K)
    return cases


def phase_kernel_k8(rng) -> dict:
    from learning3d_tpu_torch.kernels.knn import knn_pallas, knn_reference

    checked = {}
    with torch.inference_mode():
        cases = k8_cases(rng)
        for name, (q, p, k) in cases.items():
            d, i = knn_pallas(q, p, k)
            want_d, want_i = knn_reference(q, p, k)
            torch.cuda.synchronize()
            picks = int((i != want_i).sum())
            require(picks == 0 and torch.equal(d, want_d),
                    f"K8 vs plain ({name}): {picks} picks differ, distances bit-equal {torch.equal(d, want_d)}")
            checked[name] = {"B": q.shape[0], "S": q.shape[1], "N": p.shape[1], "C": q.shape[2], "k": k,
                             "picks_differing": picks, "min_distance": d.min().item()}
        require(checked["negative"]["min_distance"] < 0, "K8 (negative): no distance below 0")
        # every point equal: every distance ties, so the picks are 0 .. k-1
        for name, c in (("all_tied_xyz", 3), ("all_tied_features", 64)):
            x = torch.full((2, 1000, c), 0.37, device="cuda")
            d, i = knn_pallas(x, x, PRNET_K)
            want_d, want_i = knn_reference(x, x, PRNET_K)
            torch.cuda.synchronize()
            first = torch.arange(PRNET_K, device="cuda", dtype=torch.int32).expand_as(i)
            require(torch.equal(i, want_i) and torch.equal(d, want_d) and torch.equal(i, first),
                    f"K8 vs plain ({name}): picks must be 0 .. k-1 and distances bit-equal")
            checked[name] = {"B": 2, "S": 1000, "N": 1000, "C": c, "k": PRNET_K, "picks_differing": 0,
                             "min_distance": d.min().item()}
        times = {}
        for name in ("C3_N1024", "C64_N1024", "C128_N1024", "C3_N768", "C64_N768", "C128_N768", "cross_cloud"):
            q, p, k = cases[name]
            b_ms, b_by = k8_bound(q, p, k, q is p)
            times[name] = {"kernel_ms": cuda_ms(lambda: knn_pallas(q, p, k)),
                           "plain_ms": cuda_ms(lambda: knn_reference(q, p, k), reps=3, warmup=1),
                           "library_ms": cuda_ms(lambda: library_knn(q, p, k)), "bound_ms": b_ms, "bound_by": b_by}
    # a PRNet forward's 16 launches: each stage's C on the template once and
    # on the source three times (stages 2 and 3 share C = 64)
    forward = {key: sum((1 if n == PRNET_NT else PRNET_ITERS) * times[f"C{c}_N{n}"][key]
                        for c in (3, 64, 64, 128) for n in (PRNET_NT, PRNET_NS))
               for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    main = times["C128_N1024"]
    result = {"max_abs_err": 0.0, "max_rel_err": 0.0, **main}
    emit("kernel_k8", name="knn_pallas", tolerance="indices equal, distances bit-equal", cases=checked, times=times,
         prnet_forward_16_launches=forward, main_shape="C128_N1024 (PRNet's stage 4 on the template)",
         library="torch.cdist (f32, TF32 off) + torch.topk, yardstick only", **result)
    return result


@contextlib.contextmanager
def recorded_picks(log):
    """Record every kNN graph and keypoint selection PRNet makes, in order,
    into ``log``."""
    from learning3d_tpu_torch.models import prnet as prnet_mod

    knn, top = prnet_mod.knn, prnet_mod.KeyPointNet._top

    def knn_rec(h, k, **kw):
        idx = knn(h, k, **kw)
        log.append(("knn", idx))
        return idx

    def top_rec(self, emb):
        idx = top(self, emb)
        log.append(("keypoints", idx))
        return idx

    prnet_mod.knn, prnet_mod.KeyPointNet._top = knn_rec, top_rec
    try:
        yield
    finally:
        prnet_mod.knn, prnet_mod.KeyPointNet._top = knn, top


def pick_flips(a, b) -> dict:
    """Picks in one run and not the other, per kind: kNN neighbors (as sets
    a row) and keypoints (as sets an item)."""
    out = {"knn": 0, "keypoints": 0}
    for (kind, x), (_, y) in zip(a, b):
        width = max(int(x.max()), int(y.max())) + 1
        mx = torch.zeros(x.shape[:-1] + (width,), dtype=torch.bool, device=x.device).scatter_(-1, x, True)
        my = torch.zeros(y.shape[:-1] + (width,), dtype=torch.bool, device=y.device).scatter_(-1, y, True)
        out[kind] += int((mx & ~my).sum())
    return out


def prnet_gaps(model, source, template, control=None) -> dict:
    """The model on the kernels against the same model on the plain versions,
    at one iteration and at the model's iterations: the largest of max |k -
    p| / max |p| over est_T and transformed_source, the flipped picks, the
    graphs built. A ``control`` context, if given, is run at one iteration
    too and its gap to the plain versions recorded."""
    def rel_gap(got, want):
        return max((got[k] - want[k]).abs().max().item() / want[k].abs().max().item()
                   for k in ("est_T", "transformed_source"))

    out = {}
    iters = model.num_iters
    try:
        for n in (1, iters):
            model.num_iters = n
            logs = ([], [])
            with recorded_picks(logs[0]):
                got = model(source, template)
            with plain_versions(), recorded_picks(logs[1]):
                want = model(source, template)
            out[f"iters_{n}"] = {"rel_gap": rel_gap(got, want), "flips": pick_flips(*logs), "graphs": len(logs[0])}
            if control and n == 1:
                with control():
                    out["control_iters_1"] = {"rel_gap": rel_gap(model(source, template), want)}
    finally:
        model.num_iters = iters
    return out


def prnet_agreement(model, source, template, what, control=None) -> dict:
    """``prnet_gaps``, with one iteration held to PRNET_TOL and the
    ``control``, if given, required to fail it."""
    out = prnet_gaps(model, source, template, control)
    require(out["iters_1"]["rel_gap"] <= PRNET_TOL, f"{what}: one iteration rel gap {out['iters_1']} > {PRNET_TOL}")
    if control:
        require(out["control_iters_1"]["rel_gap"] > PRNET_TOL,
                f"{what}: the control passed the tolerance {PRNET_TOL}: {out['control_iters_1']}")
    return out


def phase_serve_prnet(rng) -> dict:
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.models import PRNet
    from learning3d_tpu_torch.serve import InferenceEngine, multistart_register, multistart_scores, rotation_starts
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    model = load_nnx_state(PRNet(), random_prnet_state(rng)).eval()
    engine = InferenceEngine(model, batch_size=PRNET_B)
    requests = [(rng.normal(size=(n, PRNET_NS, 3)).astype(np.float32),
                 rng.normal(size=(n, PRNET_NT, 3)).astype(np.float32)) for n in PRNET_REQUESTS]
    chunks = sum(-(-n // PRNET_B) for n in PRNET_REQUESTS)
    reset_launches()
    outs = [engine(s, t) for s, t in requests]  # PRNet's argument order: (source, template)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    want = {"knn_pallas": K8_PER_FORWARD * chunks, "attention_pallas": K6_PER_FORWARD * chunks}
    for name, count in launches.items():
        require(count == want.get(name, 0), f"serve_prnet: {name} launched {count} times for {chunks} chunks")
    rot_err = 0.0
    for (s, _), out in zip(requests, outs):
        require(out["est_T"].shape == (s.shape[0], 4, 4) and out["transformed_source"].shape == s.shape,
                "result shapes")
        for key, val in out.items():
            require(bool(np.isfinite(val).all()), f"every {key} finite")
        rot_err = max(rot_err, rotation_error(out["est_R"]))
    require(rot_err <= ROT_TOL, f"est_R not a rotation: {rot_err}")

    s_dev, t_dev = (torch.from_numpy(a[:PRNET_B]).cuda() for a in requests[0])
    rots = rotation_starts(IPC_STARTS)
    with torch.inference_mode():
        agree = prnet_agreement(model, s_dev, t_dev, "serve_prnet", control=k6_bf16_output)
        reset_launches()
        ms = multistart_register(model, t_dev[:PRNET_MS_PAIRS], s_dev[:PRNET_MS_PAIRS], rots)
        torch.cuda.synchronize()
        ms_launches = {k: v for k, v in LAUNCHES.items() if v}
        require(ms_launches == {"knn_pallas": K8_PER_FORWARD, "attention_pallas": K6_PER_FORWARD,
                                "_nn_oneway_pallas": 2}, f"multistart launches {ms_launches}")
        require(all(bool(torch.isfinite(v.float()).all()) for v in ms.values()), "multistart outputs finite")
        total, scores = multistart_scores(model, t_dev[:PRNET_MS_PAIRS], s_dev[:PRNET_MS_PAIRS], rots)
        require(torch.equal(scores.argmin(0), ms["start_idx"]) and torch.equal(scores.min(0).values, ms["chamfer"]),
                "multistart's result is its best start's")
        require(rotation_error(ms["est_T"][:, :3, :3].cpu()) <= ROT_TOL, "multistart est_T's rotation")
        model_ms = cuda_ms(lambda: model(s_dev, t_dev), reps=3, warmup=1)
        ms_ms = cuda_ms(lambda: multistart_register(model, t_dev[:PRNET_MS_PAIRS], s_dev[:PRNET_MS_PAIRS], rots),
                        reps=3, warmup=1)
        with plain_versions():
            plain_model_ms = cuda_ms(lambda: model(s_dev, t_dev), reps=2, warmup=1)
    engine(*requests[0])
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine(*requests[0])
    host_s = (time.perf_counter() - t0) / reps
    result = {"launches": launches, "multistart_launches": ms_launches}
    emit("serve_prnet", config={"model": "PRNet() f32 eval: PRDGCNN(512, k=20), transformer pointer, 512 keypoints, "
                                         "3 iterations", "B": PRNET_B, "source_N": PRNET_NS, "template_N": PRNET_NT},
         requests=list(PRNET_REQUESTS), chunks=chunks, launches={k: v for k, v in launches.items() if v},
         multistart={"pairs": PRNET_MS_PAIRS, "starts": IPC_STARTS, "launches": ms_launches, "ms": ms_ms,
                     "start_idx": ms["start_idx"].tolist()},
         tolerance=f"one iteration: est_T, transformed_source <= {PRNET_TOL} of max, the k6_bf16_output control "
                   "above it; 3 iterations reported",
         agree=agree, rotation={"max_RRt_minus_I_or_det": rot_err, "tolerance": ROT_TOL},
         pairs_per_s=PRNET_B / host_s, engine_ms=1e3 * host_s, model_ms=model_ms, plain_model_ms=plain_model_ms,
         model_pairs_per_s=PRNET_B / (model_ms * 1e-3))
    return result


def phase_train_prnet(rng) -> dict:
    import dataclasses
    import tempfile

    from learning3d_tpu_torch.data import RegistrationData, SyntheticModelNet40, batch_iterator, to_device
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.models import PRNet
    from learning3d_tpu_torch.train import TrainConfig, Trainer
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    state = random_prnet_state(rng)

    def build(iters=PRNET_ITERS):
        return load_nnx_state(PRNet(num_iters=iters), state)

    data = RegistrationData("PRNet", SyntheticModelNet40(num_points=PRNET_NT, size=PRNET_TRAIN_STEPS * PRNET_TRAIN_B),
                            partial_source=True)
    with tempfile.TemporaryDirectory() as ckpt:
        cfg = TrainConfig(exp_name="chip_smoke_train_prnet", task="prnet", batch_size=PRNET_TRAIN_B,
                          num_points=PRNET_NT, optimizer="adam", lr=TRAIN_LR, epochs=1, ckpt_dir=ckpt)
        trainer = Trainer(cfg, build())
        before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        reset_launches()
        with contextlib.redirect_stdout(sys.stderr):  # the Trainer's epoch line
            trainer.fit(data)
        torch.cuda.synchronize()
        launches = {k: v for k, v in LAUNCHES.items() if v}
        want = {"knn_pallas": K8_PER_FORWARD * PRNET_TRAIN_STEPS, "attention_pallas": K6_PER_FORWARD * PRNET_TRAIN_STEPS}
        require(launches == want, f"train_prnet launches {launches} in {PRNET_TRAIN_STEPS} steps (want {want})")
        epoch = trainer.history[-1]
        skipped, changed = check_trained(trainer, before)
        require(all(np.isfinite(epoch[k]) for k in ("train_rot_deg", "train_trans")), f"train metrics: {epoch}")
        batch = to_device(next(batch_iterator(data, PRNET_TRAIN_B, seed=SEED)), "cuda")
        require(batch[1].shape == (PRNET_TRAIN_B, PRNET_NS, 3) and batch[0].shape == (PRNET_TRAIN_B, PRNET_NT, 3),
                f"partial source batch {[tuple(b.shape) for b in batch]}")
        agreement = {"iters_1": step_agreement(lambda: Trainer(cfg, build(1)), batch, PRNET_STEP_TOL, plain_versions,
                                               PRNET_ZERO_GRADIENT_BIASES, PRNET_NOISE_TOL,
                                               what="PRNet train step (one iteration)", control=k6_bf16_output)}
        nudged = (batch[0], torch.nextafter(batch[1], torch.full_like(batch[1], float("inf"))), batch[2])
        runs = step_runs(lambda: Trainer(cfg, build()), batch, (contextlib.nullcontext, plain_versions))
        runs += step_runs(lambda: Trainer(cfg, build()), nudged, (plain_versions,))
        full = {}
        for label, run in (("kernels", runs[0]), ("one_ulp_source", runs[2])):
            worst, _ = step_differences(run, runs[1], PRNET_STEP_TOL, PRNET_ZERO_GRADIENT_BIASES, PRNET_NOISE_TOL)
            full[label] = {"loss": worst["loss"], "grad": worst["grad"], "grad_tensor": worst["grad_tensor"]}
        require(all(np.isfinite(r[0]) for r in runs), f"PRNet train step losses {[r[0] for r in runs]}")
        agreement[f"iters_{PRNET_ITERS}"] = full
        check_round_trip(trainer, lambda: Trainer(dataclasses.replace(cfg, resume="latest"), build()), data)
        trainer.model.train()
        torch.cuda.reset_peak_memory_stats()
        timing = time_train_step(trainer, batch, reps=3, unit="pairs")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        trainer.close()
    result = {"launches": launches, "train_loss": epoch["train_loss"], "train_rot_deg": epoch["train_rot_deg"],
              "epoch_s": epoch["seconds"], "peak_memory_gib": peak_gib, **timing}
    emit("train_prnet", config={"model": "PRNet() f32 train: PRDGCNN(512, k=20), transformer pointer, 512 keypoints, "
                                         "3 iterations", "B": PRNET_TRAIN_B, "source_N": PRNET_NS,
                                "template_N": PRNET_NT, "optimizer": "adam", "lr": TRAIN_LR,
                                "steps": PRNET_TRAIN_STEPS},
         dataset=f"RegistrationData(PRNet, partial_source=True) over {data.data_class.version_tag()}",
         skipped_steps=skipped, tensors_changed=sum(changed.values()), tensors=len(changed),
         step_vs_plain={"tolerance": f"one iteration: gradients {PRNET_STEP_TOL}, control must fail; "
                                     f"{PRNET_ITERS} iterations: reported beside a one-ulp move of the source",
                        "zero_gradient_bias_tolerance": PRNET_NOISE_TOL, **agreement},
         roundtrip="exact", **result)
    return result


# FlowNet3D() as examples/train_flownet.py trains it: B=16 pairs of N=2048
# points, f32, SGD (lr 1e-3, momentum 0.9, examples/train.py's defaults);
# served at B=16
FLOW_B, FLOW_N = 16, 2048
FLOW_REQUESTS = (16, 5, 40)
FLOW_TRAIN_STEPS, FLOW_LR, FLOW_MOMENTUM = 3, 1e-3, 0.9
# a FlowNet3D forward: sa1 and sa2 on each cloud, sa3 and sa4 on the first
# (K14 and K15 once each a layer), three_nn once (K8)
FLOW_PER_FORWARD = {"fps_pallas": 6, "ball_query_pallas": 6, "knn_pallas": 1}
# (npoint, radius, nsample) of sa1..sa4
FLOW_SA = ((1024, 0.5, 16), (256, 1.0, 16), (64, 2.0, 8), (16, 4.0, 8))
# the served flow on the kernels against the plain versions, max |k - p| <=
# FLOW_TOL * max |p|. K14, K15 and K8 give the plain versions' indices, and
# the rest is the same torch ops: tools/torch_flownet_step_gaps.py (3
# weight draws, B=16, the H100) measured 0 for the kernels and for the plain
# path run again, 0.043 to 0.127 for the control k15_nearest_first (each
# ball's nsample nearest points instead of the first nsample by index),
# which must fail the limit
FLOW_TOL = 1e-6
# one FlowNet3D train step on the kernels against the same step on the plain
# versions, per-tensor relative error. The loss and the running statistics
# come out bit-equal; the gradients differ by the order of the atomic sums
# in the gathers' backward: the tool measured 4.6e-6 to 6.6e-6 for the
# kernels and 4.3e-6 to 5.7e-6 for the plain step run again, 1.4e-2 to
# 2.3e-2 for the plain step on pc1 moved by one ulp, 1.40 to 1.55 for the
# control, which must fail. The limit lies 15x above the run-to-run spread.
# The last BatchNorm biases of sa2, sa3 and sa4 have no gradient in exact
# arithmetic (the max pool passes a shift of their channels to every row,
# and the next train-mode BatchNorm takes it out): held to FLOW_NOISE_TOL of
# their layer's weight gradient (measured 9.0e-7 to 1.1e-6)
FLOW_STEP_TOL = 1e-4
FLOW_NOISE_TOL = 1e-3
FLOW_ZERO_GRADIENT_BIASES = tuple(f"{sa}.blocks.2.bn.bias" for sa in ("sa2", "sa3", "sa4"))


def random_flownet_state(rng) -> dict:
    """A flat nnx state of FlowNet3D() with numpy-seeded weights and
    non-trivial BatchNorm statistics, keyed by the port's module paths
    (which are the JAX package's)."""
    from learning3d_tpu_torch.models import FlowNet3D
    from learning3d_tpu_torch.utils.layers import BatchNorm, Linear

    flat = {}
    for name, mod in FlowNet3D(device="cpu").named_modules():
        if isinstance(mod, Linear):
            i, o = mod.in_features, mod.out_features
            flat[f"{name}.kernel"] = rng.normal(0.0, i**-0.5, (i, o)).astype(np.float32)
            if mod.bias is not None:
                flat[f"{name}.bias"] = rng.normal(0.0, 0.1, (o,)).astype(np.float32)
        elif isinstance(mod, BatchNorm):
            random_bn(flat, rng, name, mod.num_features)
    return flat


def flow_requests(n_pairs, offset=0):
    """(pc1, pc2, color1, color2) numpy arrays of ``n_pairs`` SyntheticSceneflow
    items of N=2048 points, from item ``offset`` on."""
    from learning3d_tpu_torch.data import SyntheticSceneflow

    ds = SyntheticSceneflow(npoints=FLOW_N, size=offset + n_pairs)
    items = [ds[i] for i in range(offset, offset + n_pairs)]
    return tuple(np.stack([it[j] for it in items]) for j in range(4))


def flow_levels(xyz):
    """The clouds FlowNet3D's four set-abstraction layers sample from and
    query with: [(xyz, new_xyz, npoint, radius, nsample)] for sa1..sa4 on one
    cloud (B, N, 3), FPS by the plain version."""
    from learning3d_tpu_torch.kernels.sampling import fps_reference
    from learning3d_tpu_torch.ops.geometry import index_points

    out = []
    for npoint, radius, nsample in FLOW_SA:
        new = index_points(xyz, fps_reference(xyz, npoint).long())
        out.append((xyz, new, npoint, radius, nsample))
        xyz = new
    return out


def k14_bound(b, n, npoint) -> tuple[float, str]:
    """K14's bound: npoint - 1 steps over every point, 10 f32 instructions
    a point and step (3 differences, 3 products, 2 sums, none fused, the
    min, the comparison), on the CUDA cores; the points read once and the
    indices written once."""
    return bound(0.0, 12 * b * n + 4 * b + 4 * b * npoint, f32_ops=10.0 * b * n * max(npoint - 1, 0))


def phase_kernel_k14(rng, levels) -> dict:
    """K14 against its plain version, indices equal, at FlowNet3D's six
    calls (the SyntheticSceneflow clouds' own levels), a ragged cloud, every
    point picked, a lattice with exact ties, random starts, the register
    tiles' edges, 40 items, equal points; times and the chain floor at the
    four shapes and over a forward's six launches; npoint 1500, past the TPU
    kernel's 1024 (a limit of its VMEM the CUDA kernel does not have)."""
    from learning3d_tpu_torch.kernels import _build
    from learning3d_tpu_torch.kernels.sampling import fps_pallas, fps_reference

    cases = {}
    for cloud, lv in levels.items():
        for k, (xyz, _, npoint, _, _) in enumerate(lv):
            if cloud == "pc1" or k < 2:
                cases[f"sa{k + 1}_{cloud}"] = (xyz, npoint, None)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()  # noqa: E731
    cases["ragged"] = (dev(rng.normal(size=(3, 1000, 3))), 777, None)
    cases["every_point"] = (dev(rng.normal(size=(2, 1024, 3))), 1024, None)
    cases["ties"] = (dev(lattice_cloud(rng, 2, 1000)), 300, None)
    cases["random_starts"] = (dev(rng.normal(size=(4, 2048, 3))), 1024,
                              torch.from_numpy(rng.integers(0, 2048, 4).astype(np.int32)).cuda())
    wide_rng = np.random.default_rng([SEED + 12, 14])  # apart from the phases' shared stream
    cases["npoint_1500"] = (dev(wide_rng.normal(size=(2, 3000, 3))), 1500, None)  # past the TPU kernel's 1024
    # the register tiles' edges (K14's block size and points a thread change
    # there), past the register path (shared memory) and past shared memory
    # (the scratch); 40 items; a cloud of equal points
    edge_rng = np.random.default_rng([SEED + 12, 17])
    for n in (33, 257, 2049, 4097, 8193, 12289):
        cases[f"edge_N{n}"] = (dev(edge_rng.normal(size=(2, n, 3))), min(n, 128),
                               torch.from_numpy(edge_rng.integers(0, n, 2).astype(np.int32)).cuda())
    cases["batch_40"] = (dev(edge_rng.normal(size=(40, 1024, 3))), 256, None)
    cases["equal_points"] = (dev(np.full((2, 500, 3), 0.375)), 20, None)
    checked = {}
    with torch.inference_mode():
        for name, (xyz, npoint, start) in cases.items():
            got, want = fps_pallas(xyz, npoint, start), fps_reference(xyz, npoint, start)
            torch.cuda.synchronize()
            picks = int((got != want).sum())
            require(picks == 0, f"K14 vs plain ({name}): {picks} picks differ")
            if name == "equal_points":  # every distance 0: after the start, the first index for ever
                require(bool((got[:, 1:] == 0).all()), "K14 (equal_points): a pick after the start is not 0")
            checked[name] = {"B": xyz.shape[0], "N": xyz.shape[1], "npoint": npoint, "picks_differing": picks}
        lib = _build.library()
        stream = torch.cuda.current_stream().cuda_stream
        times = {}
        for k in range(4):
            xyz, npoint, _ = cases[f"sa{k + 1}_pc1"]
            b, n = xyz.shape[:2]
            b_ms, b_by = k14_bound(b, n, npoint)
            idx = torch.empty((b, npoint), device=xyz.device, dtype=torch.int32)
            threads = lib.fps_default_threads(n)
            times[f"sa{k + 1}"] = {"kernel_ms": cuda_ms(lambda: fps_pallas(xyz, npoint)),
                                   "plain_ms": cuda_ms(lambda: fps_reference(xyz, npoint), reps=1, warmup=1, runs=1),
                                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "threads": threads,
                                   # the steps' reductions and barriers alone, no point work
                                   "chain_floor_ms": cuda_ms(lambda: _build.check(
                                       lib.fps_chain_floor(idx.data_ptr(), b, n, npoint, stream),
                                       "fps_chain_floor"))}
    forward = {key: sum(times[f"sa{k + 1}"][key] * (2 if k < 2 else 1) for k in range(4))
               for key in ("kernel_ms", "plain_ms", "bound_ms", "chain_floor_ms")}
    result = {"max_abs_err": 0.0, "max_rel_err": 0.0, **times["sa1"]}
    emit("kernel_k14", name="fps_pallas", tolerance="indices equal", cases=checked, times=times,
         flownet_forward_6_launches=forward, main_shape="sa1 (16, 2048 -> 1024)",
         library="none: no PyTorch call computes FPS", **result)
    return result


def in_ball_scan(radius, nsample, xyz, new_xyz) -> int:
    """The points K15's queries read: each query up to its nsample-th
    in-ball point (all N where fewer are in the ball), the work this run's
    data needs."""
    from learning3d_tpu_torch.kernels.knn import _sq_dist
    from learning3d_tpu_torch.kernels.sampling import squared_radius

    total = 0
    for b in range(xyz.shape[0]):
        inside = _sq_dist(new_xyz[b : b + 1], xyz[b : b + 1]) <= torch.tensor(squared_radius(radius)).cuda()
        count = inside.int().cumsum(-1)
        reached = count >= nsample
        total += int(torch.where(reached.any(-1), reached.int().argmax(-1) + 1, xyz.shape[1]).sum())
    return total


def k15_bound(radius, nsample, xyz, new_xyz) -> tuple[float, str]:
    """K15's bound: 9 f32 instructions for each point a query reads (three
    differences, three products, two sums, none fused, the comparison), on
    the CUDA cores; the clouds read once and the (B, S, nsample) indices
    written once."""
    b, n, _ = xyz.shape
    s = new_xyz.shape[1]
    scanned = in_ball_scan(radius, nsample, xyz, new_xyz)
    return bound(0.0, 12 * b * (n + s) + 4 * b * s * nsample, f32_ops=9.0 * scanned)


def library_ball_query(radius, nsample, xyz, new_xyz):
    """Yardstick only, never used by the port: torch.cdist, torch.where of
    the in-ball indices and torch.topk of the nsample smallest."""
    n = xyz.shape[1]
    d = torch.cdist(new_xyz, xyz)
    key = torch.where(d <= radius, torch.arange(n, device=xyz.device), n)
    return torch.topk(key, nsample, dim=-1, largest=False).values


def phase_kernel_k15(rng, levels) -> dict:
    """K15 against its plain version, indices equal, at FlowNet3D's six
    calls, a ragged one, nsample = 128 and 300 (past the TPU kernel's 128),
    the on-the-radius lattice and a row whose ball is empty; times at the
    four shapes and over a forward."""
    from learning3d_tpu_torch.kernels.sampling import ball_query_pallas, ball_query_reference

    cases = {}
    for cloud, lv in levels.items():
        for k, (xyz, new, _, radius, nsample) in enumerate(lv):
            if cloud == "pc1" or k < 2:
                cases[f"sa{k + 1}_{cloud}"] = (radius, nsample, xyz, new)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()  # noqa: E731
    x = dev(rng.normal(size=(3, 1000, 3)))
    cases["ragged"] = (0.7, 16, x, x[:, :333].contiguous())
    x = levels["pc1"][0][0]
    cases["nsample_128"] = (0.5, 128, x, x[:, :256].contiguous())
    cases["nsample_300"] = (1.0, 300, x, x[:, :256].contiguous())  # past the TPU kernel's 128
    g = np.stack(np.meshgrid(*[np.arange(5)] * 3, indexing="ij"), -1).reshape(-1, 3)
    lat = dev((0.1 * g + 0.37).astype(np.float32)[rng.permutation(len(g))][None])
    cases["on_the_radius"] = (0.1, 16, lat, lat[:, :64].contiguous())
    x = dev(rng.normal(size=(2, 500, 3)))
    cases["empty_ball"] = (0.3, 8, x, torch.cat([x[:, :10], torch.full((2, 3, 3), 40.0, device="cuda")], 1))
    checked = {}
    with torch.inference_mode():
        for name, (radius, nsample, xyz, new) in cases.items():
            got, want = ball_query_pallas(radius, nsample, xyz, new), ball_query_reference(radius, nsample, xyz, new)
            wide = ball_query_pallas(radius, nsample, xyz, new, dtype=torch.int64)  # query_ball_point's instance
            torch.cuda.synchronize()
            picks = int((got != want).sum())
            require(picks == 0, f"K15 vs plain ({name}): {picks} indices differ")
            require(wide.dtype == torch.int64 and torch.equal(wide, got.long()), f"K15 int64 vs int32 ({name})")
            checked[name] = {"B": xyz.shape[0], "N": xyz.shape[1], "S": new.shape[1], "radius": radius,
                             "nsample": nsample, "indices_differing": picks,
                             "rows_with_empty_ball": int((got[..., 0] == xyz.shape[1]).sum())}
        require(checked["empty_ball"]["rows_with_empty_ball"] == 6, f"K15 empty balls: {checked['empty_ball']}")
        times = {}
        for k in range(4):
            radius, nsample, xyz, new = cases[f"sa{k + 1}_pc1"]
            b_ms, b_by = k15_bound(radius, nsample, xyz, new)
            times[f"sa{k + 1}"] = {
                "points_scanned": in_ball_scan(radius, nsample, xyz, new),
                "kernel_ms": cuda_ms(lambda: ball_query_pallas(radius, nsample, xyz, new)),
                "plain_ms": cuda_ms(lambda: ball_query_reference(radius, nsample, xyz, new), reps=5, warmup=1),
                "library_ms": cuda_ms(lambda: library_ball_query(radius, nsample, xyz, new)),
                "bound_ms": b_ms, "bound_by": b_by}
    forward = {key: sum(times[f"sa{k + 1}"][key] * (2 if k < 2 else 1) for k in range(4))
               for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    result = {"max_abs_err": 0.0, "max_rel_err": 0.0, **times["sa1"]}
    emit("kernel_k15", name="ball_query_pallas", tolerance="indices equal", cases=checked, times=times,
         flownet_forward_6_launches=forward, main_shape="sa1 (16, 1024 queries among 2048, r=0.5, nsample=16)",
         library="torch.cdist + torch.where + torch.topk, yardstick only", **result)
    return result


@contextlib.contextmanager
def k15_nearest_first():
    """The control of the FlowNet3D checks: a ball query that keeps each
    ball's nsample *nearest* points (the plain version's in-ball test, then
    a sort by distance) where K15 keeps the first nsample by index, as a
    kernel that selected by distance would."""
    from learning3d_tpu_torch.kernels import sampling
    from learning3d_tpu_torch.kernels.knn import _sq_dist

    def nearest(radius, nsample, xyz, new_xyz, dtype=torch.int32):
        n = xyz.shape[1]
        d = _sq_dist(new_xyz.float(), xyz.float())
        inside = d <= torch.tensor(sampling.squared_radius(radius), device=d.device)
        order = torch.sort(torch.where(inside, d, float("inf")), dim=-1, stable=True).indices[..., :nsample]
        key = torch.where(torch.gather(inside, -1, order), order, n)
        return torch.where(key == n, key[..., :1], key).to(dtype)

    kernel = sampling.ball_query_pallas
    sampling.ball_query_pallas = nearest
    try:
        yield
    finally:
        sampling.ball_query_pallas = kernel


def k8_three_nn(model, pc1) -> dict:
    """K8 at FlowNet3D's three_nn: pc1's points among sa1's 1024 samples of
    it (k=3, C=3), bit-equal to its plain version; its time beside the plain
    version's, torch.cdist + torch.topk's and the bound."""
    from learning3d_tpu_torch.kernels.knn import knn_pallas, knn_reference
    from learning3d_tpu_torch.ops.geometry import farthest_point_sample, index_points

    known = index_points(pc1, farthest_point_sample(pc1, model.sa1.npoint))
    d, i = knn_pallas(pc1, known, 3)
    want_d, want_i = knn_reference(pc1, known, 3)
    torch.cuda.synchronize()
    require(torch.equal(i, want_i) and torch.equal(d, want_d), "K8 at three_nn's shape vs plain")
    b_ms, b_by = k8_bound(pc1, known, 3, False)
    return {"shape": [*pc1.shape[:2], known.shape[1]], "k": 3, "kernel_ms": cuda_ms(lambda: knn_pallas(pc1, known, 3)),
            "plain_ms": cuda_ms(lambda: knn_reference(pc1, known, 3), reps=3, warmup=1),
            "library_ms": cuda_ms(lambda: library_knn(pc1, known, 3)), "bound_ms": b_ms, "bound_by": b_by}


def flow_gaps(model, inputs, control=None) -> dict:
    """The model on the kernels against the same model on the plain
    versions: max |k - p| / max |p| of the flow; and of the ``control``, if
    given."""
    got = model(*inputs)
    with plain_versions():
        want = model(*inputs)
    scale = want.abs().max().item()
    out = {"rel_gap": (got - want).abs().max().item() / scale}
    if control:
        with control():
            out["control_rel_gap"] = (model(*inputs) - want).abs().max().item() / scale
    return out


def phase_serve_flownet(rng) -> dict:
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.models import FlowNet3D
    from learning3d_tpu_torch.serve import InferenceEngine
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    model = load_nnx_state(FlowNet3D(), random_flownet_state(rng)).eval()
    engine = InferenceEngine(model, batch_size=FLOW_B)
    requests, offset = [], 0
    for n in FLOW_REQUESTS:
        requests.append(flow_requests(n, offset))
        offset += n
    chunks = sum(-(-n // FLOW_B) for n in FLOW_REQUESTS)
    reset_launches()
    outs = [engine(*r) for r in requests]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    for name, count in launches.items():
        require(count == FLOW_PER_FORWARD.get(name, 0) * chunks,
                f"serve_flownet: {name} launched {count} times for {chunks} chunks")
    for r, out in zip(requests, outs):
        require(out.shape == r[0].shape and bool(np.isfinite(out).all()), "flow shape and finite")
    inputs = [torch.from_numpy(a[:FLOW_B]).cuda() for a in requests[0]]
    with torch.inference_mode():
        k8 = k8_three_nn(model, inputs[0])
        agree = flow_gaps(model, inputs, control=k15_nearest_first)
        require(agree["rel_gap"] <= FLOW_TOL, f"serve_flownet: kernels vs plain {agree} > {FLOW_TOL}")
        require(agree["control_rel_gap"] > FLOW_TOL, f"serve_flownet: the control passed {FLOW_TOL}: {agree}")
        model_ms = cuda_ms(lambda: model(*inputs), reps=5, warmup=2)
        with plain_versions():
            plain_model_ms = cuda_ms(lambda: model(*inputs), reps=2, warmup=1)
    engine(*requests[0])
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine(*requests[0])
    host_s = (time.perf_counter() - t0) / reps
    result = {"launches": launches}
    emit("serve_flownet", config={"model": "FlowNet3D() f32 eval", "B": FLOW_B, "N": FLOW_N}, k8_three_nn=k8,
         dataset="SyntheticSceneflow", requests=list(FLOW_REQUESTS), chunks=chunks,
         launches={k: v for k, v in launches.items() if v},
         tolerance=f"flow <= {FLOW_TOL} of max against the plain versions, the k15_nearest_first control above it",
         agree=agree, pairs_per_s=FLOW_B / host_s, engine_ms=1e3 * host_s, model_ms=model_ms,
         plain_model_ms=plain_model_ms, model_pairs_per_s=FLOW_B / (model_ms * 1e-3))
    return result


def phase_train_flownet(rng) -> dict:
    import dataclasses
    import tempfile

    from learning3d_tpu_torch.data import FlowData, SyntheticSceneflow, batch_iterator, to_device
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.models import FlowNet3D
    from learning3d_tpu_torch.train import TrainConfig, Trainer
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    state = random_flownet_state(rng)

    def build():
        return load_nnx_state(FlowNet3D(), state)

    data = FlowData(SyntheticSceneflow(npoints=FLOW_N, size=FLOW_TRAIN_STEPS * FLOW_B))
    with tempfile.TemporaryDirectory() as ckpt:
        cfg = TrainConfig(exp_name="chip_smoke_train_flownet", task="flow", batch_size=FLOW_B, num_points=FLOW_N,
                          optimizer="sgd", lr=FLOW_LR, momentum=FLOW_MOMENTUM, epochs=1, ckpt_dir=ckpt)
        trainer = Trainer(cfg, build())
        before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        reset_launches()
        with contextlib.redirect_stdout(sys.stderr):  # the Trainer's epoch line
            trainer.fit(data)
        torch.cuda.synchronize()
        launches = {k: v for k, v in LAUNCHES.items() if v}
        want = {k: v * FLOW_TRAIN_STEPS for k, v in FLOW_PER_FORWARD.items()}
        require(launches == want, f"train_flownet launches {launches} in {FLOW_TRAIN_STEPS} steps (want {want})")
        epoch = trainer.history[-1]
        skipped, changed = check_trained(trainer, before)
        require(all(np.isfinite(epoch[k]) for k in ("train_epe", "train_acc3d_strict")), f"train metrics: {epoch}")
        batch = to_device(next(batch_iterator(data, FLOW_B, seed=SEED)), "cuda")
        require(len(batch) == 6 and batch[0].shape == (FLOW_B, FLOW_N, 3), "the 6-tuple flow batch")
        agreement = step_agreement(lambda: Trainer(cfg, build()), batch, FLOW_STEP_TOL, plain_versions,
                                   FLOW_ZERO_GRADIENT_BIASES, FLOW_NOISE_TOL, what="FlowNet3D train step",
                                   control=k15_nearest_first)
        check_round_trip(trainer, lambda: Trainer(dataclasses.replace(cfg, resume="latest"), build()), data)
        trainer.model.train()
        torch.cuda.reset_peak_memory_stats()
        timing = time_train_step(trainer, batch, reps=5, unit="pairs")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        trainer.close()
    result = {"launches": launches, "train_loss": epoch["train_loss"], "train_epe": epoch["train_epe"],
              "epoch_s": epoch["seconds"], "peak_memory_gib": peak_gib, **timing}
    emit("train_flownet", config={"model": "FlowNet3D() f32 train", "B": FLOW_B, "N": FLOW_N, "optimizer": "sgd",
                                  "lr": FLOW_LR, "momentum": FLOW_MOMENTUM, "steps": FLOW_TRAIN_STEPS},
         dataset="FlowData(SyntheticSceneflow)", skipped_steps=skipped, tensors_changed=sum(changed.values()),
         tensors=len(changed),
         step_vs_plain={"tolerance": f"loss, gradients, running statistics {FLOW_STEP_TOL}; the control "
                                     "k15_nearest_first must fail", "zero_gradient_bias_tolerance": FLOW_NOISE_TOL,
                        **agreement},
         roundtrip="exact", **result)
    return result


# RPMNet() as examples/train.py trains it (PPFNet: emb 96, radius 0.3, 64
# neighbours, ppf + dxyz + xyz; 5 Sinkhorn iterations, 2 RPM iterations):
# B=16 pairs of N=1024 points with normals from RegistrationData("RPMNet")
# over SyntheticModelNet40(use_normals=True), f32, Adam lr 1e-3; served at
# B=16 (BENCH_NOTES.md's RPMNet batch)
RPM_B, RPM_N = 16, 1024
RPM_REQUESTS = (16, 5)
RPM_TRAIN_STEPS, RPM_LR = 2, 1e-3
# a forward: PPFNet on the template once and on the source each iteration
# (K16 once a PPFNet), one Sinkhorn an iteration (K17); the backward
# recomputes the Sinkhorn through K17's plain version
RPM_PER_FORWARD = {"ball_group_pallas": 3, "sinkhorn_log_pallas": 2}
RPM_RADIUS, RPM_NSAMPLE = 0.3, 64
# K17 against its plain version, max |k - p| absolute on the log matrix:
# the kernel keeps row and column potentials, the plain version rewrites
# the matrix pass after pass; at RPMNet's shape both lie within 4e-6 of the
# f64 result, and 1e-5 is the JAX package's own tolerance between its
# kernel and its XLA oracle
K17_TOL = 1e-5
# the served est_T and transformed_source on the kernels against the plain
# versions, max |k - p| <= RPM_TOL * max |p|, and r (a difference of unit
# features) to RPM_TOL absolute: K16 is exact and K17 within K17_TOL, which
# the two Kabsch solves carry on; the control k17_bf16_output (K17's output
# rounded to bf16, as a kernel computing below f32 would give) must fail it
RPM_TOL = 1e-4
# one RPMNet train step on the kernels against the same step on the plain
# versions, per-tensor relative error (tools/torch_rpmnet_step_gaps.py sizes
# it beside the plain step's own spread and a one-ulp move of the source)
RPM_STEP_TOL = 1e-3
RPM_NOISE_TOL = 1e-3


def random_rpmnet_state(rng) -> dict:
    """A flat nnx state of RPMNet() with numpy-seeded weights and GroupNorm
    affines away from 1 and 0, keyed by the port's module paths (the JAX
    package's)."""
    from learning3d_tpu_torch.models import RPMNet
    from learning3d_tpu_torch.utils.layers import GroupNorm, Linear

    flat = {}
    for name, mod in RPMNet(device="cpu").named_modules():
        if isinstance(mod, Linear):
            i, o = mod.in_features, mod.out_features
            flat[f"{name}.kernel"] = rng.normal(0.0, i**-0.5, (i, o)).astype(np.float32)
            flat[f"{name}.bias"] = rng.normal(0.0, 0.1, (o,)).astype(np.float32)
        elif isinstance(mod, GroupNorm):
            flat[f"{name}.scale"] = rng.uniform(0.5, 1.5, mod.num_features).astype(np.float32)
            flat[f"{name}.bias"] = rng.normal(0.0, 0.1, mod.num_features).astype(np.float32)
    return flat


@functools.cache
def rpm_clouds():
    """The SyntheticModelNet40 clouds with normals that every RPMNet phase
    draws from (normals estimated once an item and cached)."""
    from learning3d_tpu_torch.data import SyntheticModelNet40

    return SyntheticModelNet40(num_points=RPM_N, size=RPM_TRAIN_STEPS * RPM_B, use_normals=True)


def rpm_requests(n_pairs, offset=0):
    """(template, source) numpy arrays (n, 1024, 6) of RegistrationData("RPMNet")
    items, from item ``offset`` on."""
    from learning3d_tpu_torch.data import RegistrationData

    ds = RegistrationData("RPMNet", rpm_clouds())
    items = [ds[i] for i in range(offset, offset + n_pairs)]
    return tuple(np.stack([it[j] for it in items]) for j in range(2))


def ball_group_scan(radius, nsample, xyz, new_xyz, itself) -> int:
    """The points K16's queries read: each query up to its nsample-th
    in-ball point other than itself (all N where fewer are in the ball)."""
    from learning3d_tpu_torch.kernels.knn import _sq_dist
    from learning3d_tpu_torch.kernels.sampling import squared_radius

    total = 0
    cols = torch.arange(xyz.shape[1], device=xyz.device)
    for b in range(xyz.shape[0]):
        d = _sq_dist(new_xyz[b : b + 1], xyz[b : b + 1])
        inside = (d <= torch.tensor(squared_radius(radius)).cuda()) & (cols != itself[b : b + 1, :, None])
        reached = inside.int().cumsum(-1) >= nsample
        total += int(torch.where(reached.any(-1), reached.int().argmax(-1) + 1, xyz.shape[1]).sum())
    return total


def k16_bound(radius, nsample, xyz, new_xyz, itself, values) -> tuple[float, str]:
    """K16's bound: 9 f32 instructions for each point a query reads (as
    K15's), on the CUDA cores; the clouds, the center indices and the values
    read once and the (B, S, nsample, C) values written once."""
    b, n, _ = xyz.shape
    s, c = new_xyz.shape[1], values.shape[-1]
    scanned = ball_group_scan(radius, nsample, xyz, new_xyz, itself)
    nbytes = 12 * b * (n + s) + 4 * b * s + 4 * b * n * c + 4 * b * s * nsample * c
    return bound(0.0, nbytes, f32_ops=9.0 * scanned)


def library_ball_group(radius, nsample, xyz, new_xyz, itself, values):
    """Yardstick only, never used by the port: torch.cdist, torch.where of
    the in-ball indices other than the center's, torch.topk of the nsample
    smallest, the center's index in the empty slots, and a gather."""
    n, c = xyz.shape[1], values.shape[-1]
    d = torch.cdist(new_xyz, xyz)
    cols = torch.arange(n, device=xyz.device)
    center = itself.long()[..., None]
    key = torch.where((d <= radius) & (cols != center), cols, n)
    key = torch.topk(key, nsample, dim=-1, largest=False).values
    idx = torch.where(key == n, center, key)
    return torch.gather(values, 1, idx.reshape(idx.shape[0], -1, 1).expand(-1, -1, c)).reshape(idx.shape + (c,))


def phase_kernel_k16(rng) -> dict:
    """K16 against its plain version, values equal, at RPMNet's grouping
    (the template clouds of 16 pairs: S = N = 1024, r 0.3, nsample 64, C =
    6), nsample 8 (outside the TPU gate's nsample * C % 128 == 0), N = 1000
    (not a multiple of 32), centers outside [0, N), a lattice on the radius,
    N = 20,000 (rows open across chunks; the block stopping early), nsample
    200 and 300 with C = 6 and 7; times at RPMNet's shape."""
    from learning3d_tpu_torch.kernels.sampling import ball_group_pallas, ball_group_reference

    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    pc = dev(rpm_requests(RPM_B)[0])
    xyz = pc[..., :3].contiguous()
    every = torch.arange(RPM_N, dtype=torch.int32, device="cuda").expand(RPM_B, RPM_N).contiguous()
    cases = {"rpmnet": (RPM_RADIUS, RPM_NSAMPLE, xyz, xyz, every, pc),
             "nsample_8": (RPM_RADIUS, 8, xyz, xyz, every, pc)}
    x = dev(rng.uniform(-1.0, 1.0, (3, 1000, 6)).astype(np.float32))
    cases["ragged"] = (RPM_RADIUS, RPM_NSAMPLE, x[..., :3].contiguous(), x[:, :777, :3].contiguous(),
                       torch.arange(777, dtype=torch.int32, device="cuda").expand(3, 777).contiguous(), x)
    it = every[:2].clone()
    it[:, ::7], it[:, 3::7] = -1, RPM_N
    cases["centers_outside"] = (RPM_RADIUS, RPM_NSAMPLE, xyz[:2], xyz[:2], it, pc[:2])
    g = np.stack(np.meshgrid(*[np.arange(5)] * 3, indexing="ij"), -1).reshape(-1, 3)
    lat = dev((0.1 * g + 0.37).astype(np.float32)[rng.permutation(len(g))][None])
    cases["on_the_radius"] = (0.1, 16, lat, lat, torch.arange(125, dtype=torch.int32, device="cuda")[None], lat)
    # the Hopper design's chunks of the staged cloud and its 256-slot lists,
    # from a generator of their own
    own = np.random.default_rng(SEED + 21)
    big = dev(own.uniform(-1.0, 1.0, (2, 20000, 6)).astype(np.float32))
    big_xyz, picks = big[..., :3].contiguous(), torch.arange(0, 20000, 37, dtype=torch.int32, device="cuda")
    big_it = picks.expand(2, -1).contiguous()
    big_q = big_xyz[:, picks.long()].contiguous()
    cases["chunked_open"] = (0.1, RPM_NSAMPLE, big_xyz, big_q, big_it, big)
    cases["chunked_early_stop"] = (0.5, 32, big_xyz, big_q, big_it, big)
    for c in (6, 7):
        v = dev(own.normal(size=(2, RPM_N, c)).astype(np.float32))
        cases[f"nsample_200_c{c}"] = (RPM_RADIUS, 200, xyz[:2], xyz[:2], every[:2], v)
        cases[f"long_rows_c{c}"] = (0.9, 300, xyz[:2], xyz[:2], every[:2], v)  # a 256-slot list full mid-scan
    checked = {}
    with torch.inference_mode():
        for name, args in cases.items():
            got, want = ball_group_pallas(*args), ball_group_reference(*args)
            torch.cuda.synchronize()
            differ = int((got != want).sum())
            require(differ == 0, f"K16 vs plain ({name}): {differ} values differ")
            checked[name] = {"B": args[2].shape[0], "N": args[2].shape[1], "S": args[3].shape[1], "radius": args[0],
                             "nsample": args[1], "C": args[5].shape[-1], "values_differing": differ}
        args = cases["rpmnet"]
        b_ms, b_by = k16_bound(*args)
        times = {"kernel_ms": cuda_ms(lambda: ball_group_pallas(*args)),
                 "plain_ms": cuda_ms(lambda: ball_group_reference(*args), reps=5, warmup=1),
                 "library_ms": cuda_ms(lambda: library_ball_group(*args), reps=5), "bound_ms": b_ms, "bound_by": b_by}
    result = {"max_abs_err": 0.0, "max_rel_err": 0.0, **times}
    emit("kernel_k16", name="ball_group_pallas", tolerance="values equal", cases=checked,
         main_shape="RPMNet's PPFNet grouping (16, 1024 among 1024, r 0.3, nsample 64, C 6)",
         output_mb=4 * RPM_B * RPM_N * RPM_NSAMPLE * 6 / 1e6,
         library="torch.cdist + torch.where + torch.topk + torch.gather, yardstick only", **result)
    return result


def rpm_affinity(rng, b, j, k, beta=1.0, alpha=0.7, c=96):
    """RPMNet's affinity -beta (d - alpha), d the squared distance of unit
    features, on the card."""
    f = torch.from_numpy(rng.normal(size=(b, j, c)).astype(np.float32)).cuda()
    g = torch.from_numpy(rng.normal(size=(b, k, c)).astype(np.float32)).cuda()
    f, g = f / f.norm(dim=-1, keepdim=True), g / g.norm(dim=-1, keepdim=True)
    d = (-2.0 * torch.matmul(f, g.transpose(1, 2)) + (f * f).sum(-1)[..., None]) + (g * g).sum(-1)[:, None]
    return (-beta * (d - alpha)).contiguous()


def k17_bound(b, j, k, n_iters) -> tuple[float, str]:
    """K17's bound: the matrix read once and written once, against 2 n_iters
    (J+1)(K+1) exponentials on the SFU, whichever takes longer."""
    exp_s = 2.0 * n_iters * b * (j + 1) * (k + 1) / SFU_EXP_PER_S
    bytes_s = 8.0 * b * j * k / PEAK_BYTES
    return 1e3 * max(exp_s, bytes_s), "operations" if exp_s >= bytes_s else "bytes"


def phase_kernel_k17(rng) -> dict:
    """K17 against its plain version within K17_TOL at RPMNet's shape
    (16, 1024, 1024) on affinities of RPMNet's range, at J != K, at one
    iteration and at a wide range (beta 10); times at RPMNet's shape."""
    from learning3d_tpu_torch.kernels.sinkhorn import sinkhorn_log_pallas, sinkhorn_slack_reference

    cases = {"rpmnet": (rpm_affinity(rng, RPM_B, RPM_N, RPM_N), 5),
             "j_ne_k": (rpm_affinity(rng, 3, 717, 1000, beta=3.0), 5),
             "one_iteration": (rpm_affinity(rng, 2, 1024, 1024), 1),
             "wide": (rpm_affinity(rng, 2, 513, 300, beta=10.0), 5)}
    errs = {}
    with torch.inference_mode():
        for name, (la, n_iters) in cases.items():
            got, want = sinkhorn_log_pallas(la, n_iters), sinkhorn_slack_reference(la, n_iters)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(got).all()), f"K17 ({name}): finite")
            err = (got - want).abs().max().item()
            require(err <= K17_TOL, f"K17 vs plain ({name}): max abs err {err} > {K17_TOL}")
            errs[name] = {"shape": list(la.shape), "n_iters": n_iters, "max_abs_err": err,
                          "min_log": want.min().item()}
        la, n_iters = cases["rpmnet"]
        b_ms, b_by = k17_bound(*la.shape, n_iters)
        times = {"kernel_ms": cuda_ms(lambda: sinkhorn_log_pallas(la, n_iters)),
                 "plain_ms": cuda_ms(lambda: sinkhorn_slack_reference(la, n_iters), reps=5, warmup=1),
                 "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    err = max(e["max_abs_err"] for e in errs.values())
    result = {"max_abs_err": err, "max_rel_err": err / abs(errs["rpmnet"]["min_log"]), **times}
    emit("kernel_k17", name="sinkhorn_log_pallas", tolerance=f"max abs err <= {K17_TOL}", cases=errs,
         main_shape="RPMNet's Sinkhorn (16, 1024, 1024), 5 iterations",
         library="none: no single PyTorch call computes the slack Sinkhorn (the torch.logsumexp chain is the "
                 "plain version)", **result)
    return result


@contextlib.contextmanager
def k17_bf16_output():
    """The control of the RPMNet checks: K17 with its output rounded to
    bf16, as a kernel that computed below the configuration's f32 would
    give."""
    from learning3d_tpu_torch.kernels import sinkhorn

    kernel = sinkhorn.sinkhorn_log_pallas
    sinkhorn.sinkhorn_log_pallas = lambda la, n_iters=5: kernel(la, n_iters).to(torch.bfloat16).float()
    try:
        yield
    finally:
        sinkhorn.sinkhorn_log_pallas = kernel


def rpm_gaps(model, inputs, control=None) -> dict:
    """The model on the kernels against the same model on the plain
    versions: max |k - p| / max |p| of est_T and transformed_source, max |k
    - p| of r; and of the ``control``, if given."""
    def gap(got, want):
        return max([(got[k] - want[k]).abs().max().item() / want[k].abs().max().item()
                    for k in ("est_T", "transformed_source")] + [(got["r"] - want["r"]).abs().max().item()])

    got = model(*inputs)
    with plain_versions():
        want = model(*inputs)
    out = {"rel_gap": gap(got, want)}
    if control:
        with control():
            out["control_rel_gap"] = gap(model(*inputs), want)
    return out


def phase_serve_rpmnet(rng) -> dict:
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.models import RPMNet
    from learning3d_tpu_torch.serve import InferenceEngine, _tree_map
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    model = load_nnx_state(RPMNet(), random_rpmnet_state(rng)).eval()
    engine = InferenceEngine(model, batch_size=RPM_B)
    requests, offset = [], 0
    for n in RPM_REQUESTS:
        requests.append(rpm_requests(n, offset))
        offset += n
    chunks = sum(-(-n // RPM_B) for n in RPM_REQUESTS)
    reset_launches()
    outs = [engine(*r) for r in requests]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    for name, count in launches.items():
        require(count == RPM_PER_FORWARD.get(name, 0) * chunks,
                f"serve_rpmnet: {name} launched {count} times for {chunks} chunks")
    rot_err = 0.0
    for r, out in zip(requests, outs):
        n = r[0].shape[0]
        require(out["est_T"].shape == (n, 4, 4) and len(out["perm_matrices"]) == 2, "serve_rpmnet: output shapes")
        for key in ("est_T", "r", "transformed_source"):
            require(bool(np.isfinite(out[key]).all()), f"serve_rpmnet: {key} finite")
        rot_err = max(rot_err, rotation_error(out["est_R"]))
    require(rot_err <= ROT_TOL, f"serve_rpmnet: est_R off a rotation by {rot_err}")
    arrays = []
    _tree_map(arrays.append, outs[0])
    out_mb = sum(a.nbytes for a in arrays) / 1e6
    inputs = [torch.from_numpy(a[:RPM_B]).cuda() for a in requests[0]]
    with torch.inference_mode():
        agree = rpm_gaps(model, inputs, control=k17_bf16_output)
        require(agree["rel_gap"] <= RPM_TOL, f"serve_rpmnet: kernels vs plain {agree} > {RPM_TOL}")
        require(agree["control_rel_gap"] > RPM_TOL, f"serve_rpmnet: the control passed {RPM_TOL}: {agree}")
        model_ms = cuda_ms(lambda: model(*inputs), reps=5, warmup=2)
        with plain_versions():
            plain_model_ms = cuda_ms(lambda: model(*inputs), reps=2, warmup=1)
    engine(*requests[0])
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine(*requests[0])
    host_s = (time.perf_counter() - t0) / reps
    result = {"launches": launches}
    emit("serve_rpmnet", config={"model": "RPMNet() f32 eval (PPFNet emb 96, r 0.3, 64 neighbours; 5 Sinkhorn, "
                                           "2 iterations)", "B": RPM_B, "N": RPM_N},
         dataset="RegistrationData('RPMNet', SyntheticModelNet40(use_normals=True))", requests=list(RPM_REQUESTS),
         chunks=chunks, launches={k: v for k, v in launches.items() if v}, max_rotation_error=rot_err,
         tolerance=f"est_T, transformed_source <= {RPM_TOL} of max and r <= {RPM_TOL} against the plain versions, "
                   "the k17_bf16_output control above it",
         agree=agree, output_mb_per_request=out_mb, pairs_per_s=RPM_B / host_s, engine_ms=1e3 * host_s,
         model_ms=model_ms, plain_model_ms=plain_model_ms, model_pairs_per_s=RPM_B / (model_ms * 1e-3))
    return result


def phase_train_rpmnet(rng) -> dict:
    import dataclasses
    import tempfile

    from learning3d_tpu_torch.data import RegistrationData, batch_iterator, to_device
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.models import RPMNet
    from learning3d_tpu_torch.train import TrainConfig, Trainer
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    state = random_rpmnet_state(rng)

    def build():
        return load_nnx_state(RPMNet(), state)

    data = RegistrationData("RPMNet", rpm_clouds())
    with tempfile.TemporaryDirectory() as ckpt:
        cfg = TrainConfig(exp_name="chip_smoke_train_rpmnet", task="rpmnet", batch_size=RPM_B, num_points=RPM_N,
                          optimizer="adam", lr=RPM_LR, epochs=1, ckpt_dir=ckpt)
        trainer = Trainer(cfg, build())
        before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        reset_launches()
        with contextlib.redirect_stdout(sys.stderr):  # the Trainer's epoch line
            trainer.fit(data)
        torch.cuda.synchronize()
        launches = {k: v for k, v in LAUNCHES.items() if v}
        want = {k: v * RPM_TRAIN_STEPS for k, v in RPM_PER_FORWARD.items()}
        require(launches == want, f"train_rpmnet launches {launches} in {RPM_TRAIN_STEPS} steps (want {want})")
        epoch = trainer.history[-1]
        skipped, changed = check_trained(trainer, before)
        require(all(np.isfinite(epoch[k]) for k in ("train_rot_deg", "train_trans")), f"train metrics: {epoch}")
        batch = to_device(next(batch_iterator(data, RPM_B, seed=SEED)), "cuda")
        require(len(batch) == 3 and batch[0].shape == (RPM_B, RPM_N, 6), "the (template, source, igt) batch")
        agreement = step_agreement(lambda: Trainer(cfg, build()), batch, RPM_STEP_TOL, plain_versions, (),
                                   RPM_NOISE_TOL, what="RPMNet train step", control=k17_bf16_output)
        check_round_trip(trainer, lambda: Trainer(dataclasses.replace(cfg, resume="latest"), build()), data)
        trainer.model.train()
        torch.cuda.reset_peak_memory_stats()
        timing = time_train_step(trainer, batch, reps=3, unit="pairs")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        trainer.close()
    result = {"launches": launches, "train_loss": epoch["train_loss"], "train_rot_deg": epoch["train_rot_deg"],
              "epoch_s": epoch["seconds"], "peak_memory_gib": peak_gib, **timing}
    emit("train_rpmnet", config={"model": "RPMNet() f32 train", "B": RPM_B, "N": RPM_N, "optimizer": "adam",
                                 "lr": RPM_LR, "steps": RPM_TRAIN_STEPS},
         dataset="RegistrationData('RPMNet', SyntheticModelNet40(use_normals=True))", skipped_steps=skipped,
         tensors_changed=sum(changed.values()), tensors=len(changed),
         step_vs_plain={"tolerance": f"loss, gradients {RPM_STEP_TOL}; the control k17_bf16_output must fail",
                        **agreement},
         roundtrip="exact", **result)
    return result


# -- MaskNet, PointNetLK and part segmentation --------------------------------
LK_B, LK_N, LK_NS, LK_EMB, LK_ITERS = 32, 1024, 768, 1024, 10  # examples/train.py:55-62, the PointNetLK default
LK_REQUESTS = (32, 10)
SEG_CLASSES = 40  # examples/train.py:36-38
# MaskNet with random weights scores every point near sigmoid(out's bias):
# at emb 1024 the scores of a batch spread over 0.46-0.48, about ten bf16
# steps, and dropping half of each source cloud from the pool moved them by
# 0.008 (a CPU run at this width). The served model's output layer is drawn
# MASK_OUT_SCALE times wider, so that its scores spread over 0.06-0.47; then
# pooled features moved by one bf16 step on a tenth of the channels (what K1
# against its plain version can give: another sum order) moved a score by
# up to 0.012, the half cloud by 0.21 (on the H100: K1 against its plain
# version 0.0068, the half cloud 0.232). LK_MASK_TOL (absolute, scores in
# [0, 1]) lies between them. The train phase keeps the plain draw: scaled,
# scores saturate at small widths, where the BCE gradient vanishes
MASK_OUT_SCALE = 30.0
LK_MASK_TOL = 5e-2
# PointNetLK in f32 runs no kernel: on the same input the two contexts run
# the same code, so only run-to-run differences of the card's own
# reductions may show (none did: 0.0 on the H100)
LK_SAME_TOL = 1e-6
# One train step on K3/K4 against their plain versions, per-tensor relative
# error (the H100; tools/torch_lk_step_gaps.py over two weight draws, and
# this phase's own). PointNetLK: K3's f32 statistics (bf16 hi/lo products)
# reach the loss only through the warm-up's running statistics
# (1.4e-6-1.6e-6 apart), which the finite-difference Jacobian amplifies:
# loss 8.7e-7-6.9e-6, gradients 5.1e-5-1.3e-4, the cancelling biases
# 8.6e-5-6.7e-4 of their weight's gradient. A K3 fed bf16-rounded input
# moved them about as little (gradients 1.5e-4-1.6e-4: its rounding
# averages out over 32,768 points), so the control is a K3 that lost each
# cloud's last 128-point tile (gradients 0.35-1.85). MaskNet: loss
# 1e-7-6e-7, gradients 8.7e-4-5.5e-3 (K3's f32 picks: a channel whose two
# largest values lie within ~2^-16 can take the other point, as in the
# classifier's f32 step); the control k3_misplaced 0.10-0.23. LK_STEP_TOL
# lies 7.7x over the worst reading and LK_NOISE_TOL 7.5x, MASK_STEP_TOL
# 3.6x; each lies 5x or more under its control. Phase 39 holds K3's f32
# path directly at these shapes, where a bf16-rounded input does show
LK_STEP_TOL = 1e-3
MASK_STEP_TOL = 2e-2
LK_NOISE_TOL = 5e-3
# K3 and K4 in f32 at the new paths' shapes against their plain versions,
# relative to the largest plain value (the H100, phase 39 at B=32, N=1024
# and 768). K3 multiplies through a bf16 hi/lo split (about 2^-16 of a
# product) and sums in another order: max/min 5.4e-6-5.8e-6, z at the
# indices 0, G 5.9e-6-6.5e-6, the column sum 3.7e-7-3.9e-7; fed its operands
# rounded to bf16 (k3_bf16_input): 2.3e-3, 1.4e-3-1.7e-3, 1.5e-4-1.6e-4 and
# 4.8e-5-4.9e-5. K4: dx_sp 1.5e-7, dW_sel 1.8e-7-1.9e-7; k4_bf16_input
# 2.4e-3-2.5e-3 and 1.8e-3. Each limit lies 4.6x or more over its reading;
# the controls fail every one (the column sum by 1.6x, the rest by 4.9x or
# more)
K3_F32_TOL = 1e-4
K3_F32_SUM_TOL = 3e-5
K4_F32_TOL = 1e-5
POOL_F32_SHAPES = {"pnlk_warmup": (LK_B, LK_N), "masknet_source": (LK_B, LK_NS)}
# the biases whose gradient cancels to rounding, held against their layer's
# weight gradient: PointNetLK's last encoder stage shifts the template's and
# the moved copies' features alike; in MaskNet the biases in front of a
# train-mode BatchNorm
LK_ZERO_GRADIENT_BIASES = ("feature_model.convs.4.bias", "feature_model.bns.4.bias")
MASK_ZERO_GRADIENT_BIASES = tuple(f"maskNet.feature_model.convs.{i}.bias" for i in range(5))


def random_pointnet_state(flat, rng, prefix, emb):
    dims = [3, 64, 64, 64, 128, emb]
    for k, (i, o) in enumerate(zip(dims[:-1], dims[1:])):
        random_linear(flat, rng, f"{prefix}.convs.{k}", i, o)
        random_bn(flat, rng, f"{prefix}.bns.{k}", o)


def random_masknet_state(rng, emb: int = LK_EMB) -> dict:
    """A flat nnx state of MaskNet(PointNet(emb, use_bn=True))."""
    flat = {}
    random_pointnet_state(flat, rng, "maskNet.feature_model", emb)
    dims = [2 * emb, 1024, 512, 256, 128]
    for k, (i, o) in enumerate(zip(dims[:-1], dims[1:])):
        random_linear(flat, rng, f"maskNet.h3.{k}", i, o)
    random_linear(flat, rng, "maskNet.out", 128, 1)
    return flat


def random_pnlk_state(rng, emb: int = LK_EMB) -> dict:
    """A flat nnx state of PointNetLK(PointNet(emb, use_bn=True)), dt 0.01."""
    flat = {"dt": np.full((1, 6), 1e-2, np.float32)}
    random_pointnet_state(flat, rng, "feature_model", emb)
    return flat


def random_segmentation_state(rng, emb: int = LK_EMB, classes: int = SEG_CLASSES) -> dict:
    """A flat nnx state of Segmentation(PointNet(emb, use_bn=True,
    global_feat=False), classes)."""
    flat = {}
    random_pointnet_state(flat, rng, "feature_model", emb)
    for k, (i, o) in enumerate([(emb + 64, 512), (512, 256), (256, 128), (128, classes)], 1):
        random_linear(flat, rng, f"conv{k}", i, o)
        if k < 4:
            random_bn(flat, rng, f"bn{k}", o)
    return flat


@functools.cache
def lk_clouds():
    """The SyntheticModelNet40 clouds of every MaskNet and PointNetLK phase,
    made once (~40 ms an item on the host), enough for the serving requests
    (the first LK_B also train)."""
    from learning3d_tpu_torch.data import SyntheticModelNet40

    data = SyntheticModelNet40(num_points=LK_N, size=sum(LK_REQUESTS))
    return tuple(data[i] for i in range(len(data)))


def lk_pairs(n_pairs, offset=0, masknet=False):
    """RegistrationData("PointNetLK") over the cached clouds (items offset
    .. offset + n_pairs); with ``masknet`` a 768-point partial source and
    the template's ground-truth mask."""
    from learning3d_tpu_torch.data import RegistrationData

    extra = {"partial_source": True, "additional_params": {"use_masknet": True}} if masknet else {}
    return RegistrationData("PointNetLK", lk_clouds()[offset:offset + n_pairs], **extra)


@contextlib.contextmanager
def k1_half_cloud():
    """The control of MaskNet's serving check: K1 pooling only the first
    half of each cloud's points, as a kernel that dropped its last tiles
    would."""
    from learning3d_tpu_torch.kernels import pointnet_fused

    kernel = pointnet_fused.pointnet_pooled_kernel
    pointnet_fused.pointnet_pooled_kernel = lambda x, ws, bs: kernel(x[:, : x.shape[1] // 2].contiguous(), ws, bs)
    try:
        yield
    finally:
        pointnet_fused.pointnet_pooled_kernel = kernel


@contextlib.contextmanager
def k3_misplaced():
    """The control of MaskNet's step check: K3 whose argmax and argmin on
    every 64th channel name the next point, as a kernel that mixed up its
    point offsets would (the values stay right; the backward scatters to
    the wrong rows)."""
    from learning3d_tpu_torch.utils import layers

    kernel = layers.pool_stats

    def misplaced(x, W, c):
        mx, mn, amax, amin, G, colsum = kernel(x, W, c)
        bad = torch.zeros_like(amax, dtype=torch.bool)
        bad[:, ::64] = True
        n = x.shape[1]
        return mx, mn, torch.where(bad, (amax + 1) % n, amax), torch.where(bad, (amin + 1) % n, amin), G, colsum

    layers.pool_stats = misplaced
    try:
        yield
    finally:
        layers.pool_stats = kernel


@contextlib.contextmanager
def k3_last_tile_dropped():
    """The control of PointNetLK's step check: K3 reading each cloud but its
    last 128-point tile, as a kernel that lost its last tile would (the
    statistics then sum over 7/8 of the points)."""
    from learning3d_tpu_torch.utils import layers

    kernel = layers.pool_stats
    layers.pool_stats = lambda x, W, c: kernel(x[:, : x.shape[1] - 128].contiguous(), W, c)
    try:
        yield
    finally:
        layers.pool_stats = kernel


def phase_serve_masknet_pnlk(rng) -> dict:
    from learning3d_tpu_torch.data import batch_iterator
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.models import MaskNet, PointNet, PointNetLK
    from learning3d_tpu_torch.models.masknet import top_indices
    from learning3d_tpu_torch.serve import InferenceEngine
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    bf16 = torch.bfloat16
    state = random_masknet_state(rng)
    state["maskNet.out.kernel"] *= MASK_OUT_SCALE
    masknet = load_nnx_state(MaskNet(PointNet(emb_dims=LK_EMB, use_bn=True, dtype=bf16), dtype=bf16), state).eval()
    pnlk = load_nnx_state(PointNetLK(PointNet(emb_dims=LK_EMB, use_bn=True)), random_pnlk_state(rng)).eval()
    mask_engine, lk_engine = InferenceEngine(masknet, batch_size=LK_B), InferenceEngine(pnlk, batch_size=LK_B)
    offsets = np.cumsum((0,) + LK_REQUESTS[:-1])
    requests = [next(batch_iterator(lk_pairs(n, int(o), masknet=True), n, shuffle=False))
                for n, o in zip(LK_REQUESTS, offsets)]
    chunks = sum(-(-n // LK_B) for n in LK_REQUESTS)

    def workflow(template, source):
        masked, mask = mask_engine(template, source)
        return masked, mask, lk_engine(masked, source)

    reset_launches()
    outs = [workflow(t, s) for t, s, _, _ in requests]
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    require(launches == {"pointnet_pooled_kernel": chunks},
            f"serve_masknet_pnlk launches {launches} for {chunks} MaskNet chunks (want K1 once a chunk)")
    rot_err = 0.0
    for (t, s, _, _), (masked, mask, out) in zip(requests, outs):
        n = t.shape[0]
        require(masked.shape == (n, LK_NS, 3) and mask.shape == (n, LK_N) and out["est_T"].shape == (n, 4, 4),
                "result shapes")
        require(out["est_T_series"].shape[1:] == (LK_B, 4, 4), "est_T_series is (iterations cut to rows, B, 4, 4)")
        for name, val in (("masked template", masked), ("mask", mask), *out.items()):
            require(bool(np.isfinite(val).all()), f"every {name} finite")
        rot_err = max(rot_err, rotation_error(out["est_R"]))
    require(rot_err <= ROT_TOL, f"est_R not a rotation: {rot_err} > {ROT_TOL}")

    t_dev, s_dev = (torch.from_numpy(a[:LK_B]).cuda() for a in requests[0][:2])
    with torch.inference_mode():
        k_masked, k_mask = masknet(t_dev, s_dev)
        with plain_versions():
            p_masked, p_mask = masknet(t_dev, s_dev)
        with k1_half_cloud():
            c_mask = masknet(t_dev, s_dev)[1]
        mask_err = (k_mask.float() - p_mask.float()).abs().max().item()
        control_err = (c_mask.float() - p_mask.float()).abs().max().item()
        require(mask_err <= LK_MASK_TOL, f"MaskNet's mask, kernels vs plain: {mask_err} > {LK_MASK_TOL}")
        require(control_err > LK_MASK_TOL, f"the control k1_half_cloud passed: {control_err} <= {LK_MASK_TOL}")
        k_picks, p_picks = top_indices(k_mask, LK_NS), top_indices(p_mask, LK_NS)
        overlap = [len(np.intersect1d(a, b)) / LK_NS for a, b in zip(k_picks.cpu().numpy(), p_picks.cpu().numpy())]
        k_out = pnlk(k_masked, s_dev)
        with plain_versions():
            p_out = pnlk(k_masked, s_dev)
            chain = pnlk(p_masked, s_dev)
        same_err = (k_out["est_T"] - p_out["est_T"]).abs().max().item()
        require(same_err <= LK_SAME_TOL, f"PointNetLK on the same input, kernels vs plain: {same_err}")
        same = (k_picks == p_picks).all(-1)
        chain_err = (k_out["est_T"] - chain["est_T"]).abs().amax((1, 2))
        require(bool((chain_err[same] <= LK_SAME_TOL).all()), "the chain's est_T where the picks agree")
        mask_ms = cuda_ms(lambda: masknet(t_dev, s_dev), reps=5)
        with plain_versions():
            plain_mask_ms = cuda_ms(lambda: masknet(t_dev, s_dev), reps=3, warmup=1)
        lk_ms = cuda_ms(lambda: pnlk(k_masked, s_dev), reps=3, warmup=1)
        lk_full_ms = cuda_ms(lambda: pnlk(t_dev, s_dev), reps=3, warmup=1)
    reps = 3
    workflow(*requests[0][:2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        workflow(*requests[0][:2])
    host_s = (time.perf_counter() - t0) / reps
    result = {"launches": launches.get("pointnet_pooled_kernel", 0), "mask_ms": mask_ms, "pnlk_ms": lk_ms}
    emit("serve_masknet_pnlk", config={"masknet": "MaskNet(PointNet(1024, use_bn=True)) bf16 eval",
                                       "pointnetlk": f"PointNetLK(PointNet(1024, use_bn=True)) f32 eval, "
                                                     f"{LK_ITERS} iterations",
                                       "B": LK_B, "template": LK_N, "source": LK_NS},
         requests=list(LK_REQUESTS), chunks=chunks, launches=launches,
         mask_vs_plain={"tolerance": f"max |mask| difference <= {LK_MASK_TOL}; the control k1_half_cloud must fail",
                        "max_abs": mask_err, "control": control_err, "picks_overlap_min": min(overlap),
                        "pairs_with_equal_picks": int(same.sum())},
         pnlk_vs_plain={"tolerance": LK_SAME_TOL, "same_input": same_err,
                        "chain_where_picks_differ": chain_err[~same].max().item() if (~same).any() else 0.0},
         rotation={"max_RRt_minus_I_or_det": rot_err, "tolerance": ROT_TOL},
         model_ms={"masknet": mask_ms, "masknet_plain": plain_mask_ms, "pointnetlk_masked": lk_ms,
                   "pointnetlk_full_template": lk_full_ms},
         workflow_ms=1e3 * host_s, pairs_per_s=LK_B / host_s)
    return result


def train_one_step(name, cfg, build, data, batch, tol, zero_gradient, want_launches, control=None, what="",
                   plain=None, noise_tol=LK_NOISE_TOL):
    """One step through Trainer.fit (a dataset of one batch), the launches
    it made, the checks of check_trained, the step against the plain
    versions (``plain``, by default those of K3 and K4; with ``control``
    that must fail), and the step's parts."""
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.train import Trainer

    trainer = Trainer(cfg, build())
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    reset_launches()
    with contextlib.redirect_stdout(sys.stderr):  # the Trainer's epoch line
        trainer.fit(data)
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    require(launches == want_launches, f"{name} launches {launches} (want {want_launches})")
    epoch = trainer.history[-1]
    skipped, changed = check_trained(trainer, before)
    agreement = None
    if control is not None:
        agreement = step_agreement(lambda: Trainer(cfg, build()), batch, tol, plain or plain_poolgrad, zero_gradient,
                                   noise_tol, what=what, control=control)
    timing = time_train_step(trainer, batch, reps=3, unit="pairs" if len(batch) > 2 else "clouds")
    trainer.close()
    return {"launches": launches, "train_loss": epoch["train_loss"], "epoch_s": epoch["seconds"],
            "skipped_steps": skipped, "tensors_changed": sum(changed.values()), "tensors": len(changed),
            "step_vs_plain": agreement, **timing}


def phase_train_pnlk(rng) -> dict:
    import tempfile

    from learning3d_tpu_torch.data import batch_iterator, to_device
    from learning3d_tpu_torch.models import PointNet, PointNetLK
    from learning3d_tpu_torch.train import TrainConfig
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    state = random_pnlk_state(rng)
    data = lk_pairs(LK_B)
    batch = to_device(next(batch_iterator(data, LK_B, seed=SEED)), "cuda")
    with tempfile.TemporaryDirectory() as ckpt:
        cfg = TrainConfig(exp_name="chip_smoke_train_pnlk", task="pointnetlk", batch_size=LK_B, num_points=LK_N,
                          optimizer="adam", lr=TRAIN_LR, epochs=1, ckpt_dir=ckpt)
        result = train_one_step("train_pnlk", cfg, lambda: load_nnx_state(
            PointNetLK(PointNet(emb_dims=LK_EMB, use_bn=True)), state), data, batch, LK_STEP_TOL,
            LK_ZERO_GRADIENT_BIASES, {"pool_stats_pallas": 2}, k3_last_tile_dropped, "PointNetLK train step")
    emit("train_pnlk", config={"model": f"PointNetLK(PointNet(1024, use_bn=True)) f32, {LK_ITERS} iterations",
                               "B": LK_B, "N": LK_N, "optimizer": "adam", "lr": TRAIN_LR, "steps": 1,
                               "task": "pointnetlk"},
         tolerance=f"loss, gradients, statistics {LK_STEP_TOL}; the control k3_last_tile_dropped must fail",
         **result)
    return result


def phase_train_masknet(rng) -> dict:
    import tempfile

    from learning3d_tpu_torch.data import batch_iterator, to_device
    from learning3d_tpu_torch.models import MaskNet, PointNet
    from learning3d_tpu_torch.train import TrainConfig
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    state = random_masknet_state(rng)
    data = lk_pairs(LK_B, masknet=True)
    batch = to_device(next(batch_iterator(data, LK_B, seed=SEED)), "cuda")
    require(len(batch) == 4 and batch[1].shape == (LK_B, LK_NS, 3), "the (template, source, igt, mask) batch")
    with tempfile.TemporaryDirectory() as ckpt:
        cfg = TrainConfig(exp_name="chip_smoke_train_masknet", task="masknet", batch_size=LK_B, num_points=LK_N,
                          optimizer="adam", lr=TRAIN_LR, epochs=1, masknet_loss="bce", ckpt_dir=ckpt)
        result = train_one_step("train_masknet", cfg, lambda: load_nnx_state(
            MaskNet(PointNet(emb_dims=LK_EMB, use_bn=True)), state), data, batch, MASK_STEP_TOL,
            MASK_ZERO_GRADIENT_BIASES, {"pool_stats_pallas": 1, "pool_bwd_pallas": 1}, k3_misplaced,
            "MaskNet train step")
    emit("train_masknet", config={"model": "MaskNet(PointNet(1024, use_bn=True)) f32", "B": LK_B,
                                  "template": LK_N, "source": LK_NS, "optimizer": "adam", "lr": TRAIN_LR,
                                  "steps": 1, "loss": "bce"},
         tolerance=f"loss, gradients, statistics {MASK_STEP_TOL}; the control k3_misplaced must fail", **result)
    return result


def phase_train_seg(rng) -> dict:
    import tempfile

    from learning3d_tpu_torch.data import SegmentationData, SyntheticPartSegmentation, batch_iterator, to_device
    from learning3d_tpu_torch.models import PointNet, Segmentation
    from learning3d_tpu_torch.train import TrainConfig
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    state = random_segmentation_state(rng)
    data = SegmentationData(SyntheticPartSegmentation(num_points=LK_N, size=LK_B))
    batch = to_device(next(batch_iterator(data, LK_B, seed=SEED)), "cuda")
    with tempfile.TemporaryDirectory() as ckpt:
        cfg = TrainConfig(exp_name="chip_smoke_train_seg", task="segmentation", batch_size=LK_B, num_points=LK_N,
                          optimizer="adam", lr=TRAIN_LR, epochs=1, ckpt_dir=ckpt)
        result = train_one_step("train_seg", cfg, lambda: load_nnx_state(
            Segmentation(PointNet(emb_dims=LK_EMB, use_bn=True, global_feat=False), SEG_CLASSES), state), data,
            batch, None, (), {})
    require(np.isfinite(result["train_loss"]), f"segmentation loss {result['train_loss']}")
    emit("train_seg", config={"model": "Segmentation(PointNet(1024, use_bn=True, global_feat=False), 40) f32",
                              "B": LK_B, "N": LK_N, "optimizer": "adam", "lr": TRAIN_LR, "steps": 1},
         dataset="SyntheticPartSegmentation", **result)
    return result


def k4_f32_errors(got, want) -> dict:
    errs = {key: (g - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
            for key, g, r in (("dx", got[0], want[0]), ("dW", got[1], want[1]))}
    return {**errs, "abs": max((g - r).abs().max().item() for g, r in zip(got, want))}


def over_limits(errs, limits) -> list:
    return [key for key, tol in limits.items() if errs[key] > tol]


def phase_kernel_pool_f32(rng) -> dict:
    """K3 and K4 in f32 at the shapes of PointNetLK's warm-up and MaskNet's
    source pool, against their plain versions; the kernels fed bf16-rounded
    operands must fail the same limits."""
    from learning3d_tpu_torch.kernels.poolgrad import pool_bwd, pool_bwd_reference, pool_stats, pool_stats_reference

    k3_limits = {"max_min": K3_F32_TOL, "z_at_index": K3_F32_TOL, "G": K3_F32_SUM_TOL, "colsum": K3_F32_SUM_TOL}
    k4_limits = {"dx": K4_F32_TOL, "dW": K4_F32_TOL}
    rounded = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    cases = {}
    with torch.inference_mode():
        for name, (b, n) in POOL_F32_SHAPES.items():
            x, w, c = pool_tail_inputs(rng, b, n, LK_EMB, torch.float32)
            want = pool_stats_reference(x, w, c)
            got = pool_stats(x, w, c)
            k3 = pool_stats_gaps(got, want, x, w, c, name)
            k3_control = pool_stats_gaps(pool_stats(rounded(x), rounded(w), c), want, x, w, c, name)
            idx = got[2]
            dsel = torch.from_numpy(rng.normal(size=idx.shape).astype(np.float32)).cuda()
            want4 = pool_bwd_reference(idx, dsel, w, x)
            k4 = k4_f32_errors(pool_bwd(idx, dsel, w, x), want4)
            k4_control = k4_f32_errors(pool_bwd(idx, dsel, rounded(w), rounded(x)), want4)
            torch.cuda.synchronize()
            failed = over_limits(k3, k3_limits) + over_limits(k4, k4_limits)
            require(not failed, f"f32 K3/K4 ({name}) over their limits in {failed}: {k3} {k4}")
            k3_caught, k4_caught = over_limits(k3_control, k3_limits), over_limits(k4_control, k4_limits)
            require(bool(k3_caught), f"the control k3_bf16_input ({name}) passed: {k3_control}")
            require(bool(k4_caught), f"the control k4_bf16_input ({name}) passed: {k4_control}")
            cases[name] = {
                "B": b, "N": n, "k3": k3, "k3_bf16_input": {**k3_control, "over": k3_caught},
                "k4": k4, "k4_bf16_input": {**k4_control, "over": k4_caught},
                "k3_ms": cuda_ms(lambda: pool_stats(x, w, c)),
                "k3_plain_ms": cuda_ms(lambda: pool_stats_reference(x, w, c), reps=5, warmup=1),
                "k3_bound_ms": k3_bound(x, w)[0],
                "k4_ms": cuda_ms(lambda: pool_bwd(idx, dsel, w, x)),
                "k4_plain_ms": cuda_ms(lambda: pool_bwd_reference(idx, dsel, w, x), reps=5, warmup=1),
                "k4_bound_ms": k4_bound(idx, w, x)[0],
            }
    emit("kernel_pool_f32", tolerance={"k3": k3_limits, "k4": k4_limits,
                                       "controls": "k3_bf16_input and k4_bf16_input must fail"},
         K=K_TAIL, E=LK_EMB, cases=cases)
    return {
        "k3_abs": max(case["k3"]["abs"] for case in cases.values()),
        "k3_rel": max(case["k3"]["max_min"] for case in cases.values()),
        "k4_abs": max(case["k4"]["abs"] for case in cases.values()),
        "k4_rel": max(max(case["k4"]["dx"], case["k4"]["dW"]) for case in cases.values()),
    }


# -- PointConv, CurveNet and the DGCNN classifier ------------------------------
# examples/train_pointconv.py's PointConvDensityClsSsg(classifier=True),
# examples/train_curvenet.py's CurveNet() (k 20, the default curves) and
# examples/train.py:34-35's dgcnn-cls, Classifier(DGCNN(1024, k=20)), each
# on 40 classes at examples/train.py's batch (32) and points (1024)
CLS_B, CLS_N, DGCNN_CLS_EMB, DGCNN_CLS_K = 32, 1024, 1024, 20
# a forward's launches: PointConv samples 1024 -> 512 -> 128 and selects
# k 32 among 1024 for 512 queries and k 64 among 512 for 128 queries;
# CurveNet one self kNN (21 of 1024; at 256 and 64 points its kNN lies below
# K8's gate), two masked max pools (1024 -> 256, r 0.1; 256 -> 64, r 0.2;
# 20 members each); the bf16 DGCNN classifier K5 once, the f32 one K7 once
PC_PER_FORWARD = {"fps_pallas": 2, "knn_pallas": 2}
CURVE_PER_FORWARD = {"knn_pallas": 1, "fps_pallas": 2, "ball_query_pallas": 2}
PC_KNN = ((512, 32, CLS_N), (128, 64, 512))  # (queries, k, points) of sa1 and sa2
# PointConv scales each neighbour's features by its DensityNet's output, a
# ReLU of a one-channel BatchNorm: random weights left it 0 at every point
# of sa3 and of 97% of sa2's (a CPU run of this draw), so the logits did not
# depend on the cloud and no check could see a kernel. The drawn weights
# keep that BatchNorm's bias at LIVE_DENSITY_BIAS, where every scale is
# positive, as a trained model's density reweighting is
LIVE_DENSITY_BIAS = 1.0
CURVE_POOLS = ((CLS_N, 256, 0.1, 20), (256, 64, 0.2, 20))  # (N, npoint, radius, nsample)
CURVE_LR, CURVE_WD, CURVE_SMOOTHING = 0.1, 1e-4, 0.2  # examples/train_curvenet.py
# the f32 PointConv and CurveNet logits on the kernels against the plain
# versions: K8, K14 and K15 pick the plain versions' indices, so the same
# arithmetic follows (the walk's picks too); held to CLS_SAME_TOL of max
# (CurveNet 0.0 on the H100, its control k15_nearest_first 2.4e-3). The
# bf16 DGCNN classifier on K5: K5 and its plain version sum in other orders
# and can round an activation to the neighbouring bf16 value: 3.8e-3 of max
# on the H100, a K5 keeping half of each neighbour list (the control
# k5_half_neighbours) 4.0e-2; CLS_BF16_TOL lies 3.9x over the one and 2.7x
# under the other. PointConv's control: K8 losing its k-th pick
CLS_SAME_TOL = 1e-6
CLS_BF16_TOL = 1.5e-2
# one train step on K8/K14/K15 (PointConv, CurveNet) or K7 (the f32 DGCNN
# classifier) against the same step on their plain versions: the kernels
# pick the same indices, so only the backward's atomic sums (the gathers'
# scatter-adds) differ in order; per-tensor relative error, and the biases
# in front of a train-mode BatchNorm (no exact gradient) against their
# layer's weight gradient. Gradients that sum many cancelling terms feel
# that order: PointConv's first DensityNet layer (its one-channel
# BatchNorms see density ratios that barely vary; on the CPU JAX's own f32
# gradient there lies 2.4x its norm from its f64 one) and CurveNet's walk
# BatchNorm(1). On the H100 the kernels lay from the plain versions
# PointConv 1.7e-4-5.0e-4 (1.1e-3 on a draw whose density scales were
# dead), CurveNet 5.2e-6-1.7e-4, the DGCNN classifier 0.0; PointConv's step
# run twice on the kernels 3.0e-4-3.5e-4 (biases 6.7e-4-7.1e-4); the
# controls k8_last_pick_repeated 7.7-9.4, k15_nearest_first 0.38,
# k7_kth_swapped (K7 taking the (k+1)-th nearest for the k-th) 0.85-1.4.
# CLS_STEP_TOL lies 10x over the worst kernel reading and 76x under the
# smallest control. The phases report run_to_run, the spread of the same
# step on the kernels twice
CLS_STEP_TOL = 5e-3
CLS_NOISE_TOL = 5e-3
PC_ZERO_GRADIENT_BIASES = tuple(
    f"sa{i}.{blocks}.{j}.lin.bias" for i in (1, 2, 3) for blocks, n in (("mlp_blocks", 3), ("weightnet.blocks", 3),
                                                                     ("densitynet.blocks", 3)) for j in range(n)
) + tuple(f"sa{i}.linear.bias" for i in (1, 2, 3)) + ("fc1.bias", "fc2.bias")
DGCNN_CLS_ZERO_GRADIENT_BIASES = ("linear1.bias", "linear2.bias")


def randomize_batchnorms(model, rng):
    """Non-trivial BatchNorm statistics and affine for every BatchNorm of a
    port model, from ``rng`` (random_bn's draws)."""
    from learning3d_tpu_torch.utils.layers import BatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.num_features
                for t, a in ((m.weight, rng.uniform(0.5, 1.5, c)), (m.bias, rng.normal(0.0, 0.1, c)),
                             (m.running_mean, rng.normal(0.0, 0.2, c)), (m.running_var, rng.uniform(0.5, 1.5, c))):
                    t.copy_(torch.from_numpy(a.astype(np.float32)))
    return model


def seeded_state(make, rng) -> dict:
    """The state of ``make(generator)`` with its Linear weights drawn from a
    CPU generator seeded from ``rng`` and its BatchNorms randomized, on the
    card."""
    gen = torch.Generator().manual_seed(int(rng.integers(2**31)))
    model = randomize_batchnorms(make(gen), rng)
    return {k: v.clone() for k, v in model.state_dict().items()}


def from_state(make, state):
    """A fresh ``make(None)`` holding ``state``, its dropout masks from a
    generator of its own seeded with SEED (equal for every model built so)."""
    model = make(None)
    model.load_state_dict(state)
    return model


def make_pointconv(gen, dtype=None):
    from learning3d_tpu_torch.models import PointConvDensityClsSsg

    return PointConvDensityClsSsg(classifier=True, num_classes=CLASSES, dtype=dtype, generator=gen,
                                  dropout_generator=torch.Generator(device="cuda").manual_seed(SEED))


def make_curvenet(gen, dtype=None):
    from learning3d_tpu_torch.models import CurveNet

    return CurveNet(num_classes=CLASSES, dtype=dtype, generator=gen,
                    dropout_generator=torch.Generator(device="cuda").manual_seed(SEED))


def make_dgcnn_cls(gen, dtype=None):
    from learning3d_tpu_torch.models import DGCNN, Classifier

    return Classifier(DGCNN(emb_dims=DGCNN_CLS_EMB, k=DGCNN_CLS_K, dtype=dtype, generator=gen), CLASSES, dtype=dtype,
                      generator=gen, dropout_generator=torch.Generator(device="cuda").manual_seed(SEED))


@functools.cache
def cls_data():
    """ClassificationData over CLS_B SyntheticModelNet40 clouds of CLS_N
    points, made once for every classification phase of this family."""
    from learning3d_tpu_torch.data import ClassificationData, SyntheticModelNet40

    return ClassificationData(SyntheticModelNet40(num_points=CLS_N, size=CLS_B))


def cls_batch():
    """(clouds (CLS_B, CLS_N, 3), labels) on the card, the data's one batch."""
    from learning3d_tpu_torch.data import batch_iterator, to_device

    return to_device(next(batch_iterator(cls_data(), CLS_B, seed=SEED)), "cuda")


@contextlib.contextmanager
def k8_last_pick_repeated():
    """The control of PointConv's checks: K8 returning its nearest pick in
    the last slot too, as a kernel that lost its k-th pick would."""
    from learning3d_tpu_torch.kernels import knn

    kernel = knn.knn_pallas

    def repeated(q, p, k):
        d, i = kernel(q, p, k)
        return torch.cat([d[..., :-1], d[..., :1]], -1), torch.cat([i[..., :-1], i[..., :1]], -1)

    knn.knn_pallas = repeated
    try:
        yield
    finally:
        knn.knn_pallas = kernel


@contextlib.contextmanager
def k7_kth_swapped():
    """The control of the f32 DGCNN classifier's step: K7's edge features
    with the (k+1)-th nearest in place of the k-th."""
    from learning3d_tpu_torch.kernels import edgeconv

    kernel = edgeconv.edge_features

    def swapped(x, k):
        e = kernel(x, k + 1)
        return torch.cat([e[:, :, : k - 1], e[:, :, k:]], 2)

    edgeconv.edge_features = swapped
    try:
        yield
    finally:
        edgeconv.edge_features = kernel


@contextlib.contextmanager
def k5_half_neighbours():
    """The control of the bf16 DGCNN classifier's serving check: K5 keeping
    the k / 2 nearest of each point."""
    from learning3d_tpu_torch.models import dgcnn

    kernel = dgcnn.dgcnn_encode_packed
    dgcnn.dgcnn_encode_packed = lambda x, pack, k, approx_knn=False: kernel(x, pack, k // 2, approx_knn=approx_knn)
    try:
        yield
    finally:
        dgcnn.dgcnn_encode_packed = kernel


def serve_classifier(phase, model, per_chunk, tol, control, config) -> dict:
    """One request of CLS_B clouds through InferenceEngine: the launches a
    chunk (``per_chunk``, nothing else), the logits finite; the model on the
    kernels against the plain versions (max |k - p| <= tol * max |p|, the
    argmax agreement reported) and the ``control`` outside ``tol``; model_ms
    and clouds/s. The phase's line is printed before its gates are
    required."""
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.serve import InferenceEngine

    clouds = np.stack([cls_data()[i][0] for i in range(CLS_B)]).astype(np.float32)
    engine = InferenceEngine(model, batch_size=CLS_B)
    reset_launches()
    out = engine(clouds)
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    x = torch.from_numpy(clouds).cuda()
    with torch.inference_mode():
        got = model(x).float()
        with plain_versions():
            want = model(x).float()
        with control():
            other = model(x).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
        control_err = (other - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
        model_ms = cuda_ms(lambda: model(x), reps=3, warmup=1, runs=1)
        with plain_versions():
            plain_ms = cuda_ms(lambda: model(x), reps=1, warmup=1, runs=1)
    engine(clouds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine(clouds)
    host_s = time.perf_counter() - t0
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    emit(phase, config=config, B=CLS_B, N=CLS_N, launches=launches,
         vs_plain={"tolerance": f"max|k-p| <= {tol}*max|p|; the control {control.__name__} must fail",
                   "rel": err, "argmax_agree": agree, "control": control_err},
         model_ms=model_ms, model_ms_plain=plain_ms, engine_ms=1e3 * host_s, clouds_per_s=CLS_B / host_s)
    require(launches == per_chunk, f"{phase}: launches {launches} for one chunk (want {per_chunk})")
    require(out.shape == (CLS_B, CLASSES) and bool(np.isfinite(out).all()), f"{phase}: logits {out.shape}, finite")
    require(err <= tol, f"{phase}: kernels vs plain {err} > {tol}")
    require(control_err > tol, f"{phase}: the control {control.__name__} passed: {control_err} <= {tol}")
    return {"launches": launches, "model_ms": model_ms}


def train_classifier(phase, make, state, cfg_extra, zero_gradient, want_launches, control, config) -> dict:
    """One step of examples/train*.py's recipe (``cfg_extra``) through
    Trainer.fit on the family's one batch, the checks of train_one_step
    against the plain versions of K5-K17 with ``control``, and the same
    step twice on the kernels (the spread of the sum order alone)."""
    import tempfile

    from learning3d_tpu_torch.train import TrainConfig, Trainer

    with tempfile.TemporaryDirectory() as ckpt:
        cfg = TrainConfig(exp_name=f"chip_smoke_{phase}", task="classification", batch_size=CLS_B, num_points=CLS_N,
                          epochs=1, ckpt_dir=ckpt, **cfg_extra)
        build = lambda: from_state(make, state)  # noqa: E731
        result = train_one_step(phase, cfg, build, cls_data(), cls_batch(), CLS_STEP_TOL, zero_gradient, want_launches,
                                control, f"{phase} step", plain=plain_versions, noise_tol=CLS_NOISE_TOL)
        runs = step_runs(lambda: Trainer(cfg, build()), cls_batch(), (contextlib.nullcontext,) * 2)
        result["run_to_run"] = step_differences(*runs, float("inf"), zero_gradient, float("inf"))[0]
    emit(phase, config={**config, "B": CLS_B, "N": CLS_N, "steps": 1, **cfg_extra},
         tolerance=f"loss, gradients, statistics {CLS_STEP_TOL} (cancelling biases {CLS_NOISE_TOL} of their "
                   f"weight's); the control {control.__name__} must fail", dataset="SyntheticModelNet40", **result)
    return result


def pointconv_state(rng) -> dict:
    """seeded_state of PointConv with each DensityNet's last BatchNorm bias
    at LIVE_DENSITY_BIAS."""
    state = seeded_state(make_pointconv, rng)
    for sa in ("sa1", "sa2", "sa3"):
        state[f"{sa}.densitynet.blocks.2.bn.bias"].fill_(LIVE_DENSITY_BIAS)
    return state


def phase_serve_pointconv(rng) -> dict:
    model = from_state(make_pointconv, pointconv_state(rng)).eval()
    return serve_classifier("serve_pointconv", model, PC_PER_FORWARD, CLS_SAME_TOL, k8_last_pick_repeated,
                            "PointConvDensityClsSsg(classifier=True), 40 classes, f32 eval")


def phase_train_pointconv(rng) -> dict:
    return train_classifier("train_pointconv", make_pointconv, pointconv_state(rng),
                            {"optimizer": "adam", "lr": TRAIN_LR}, PC_ZERO_GRADIENT_BIASES, PC_PER_FORWARD,
                            k8_last_pick_repeated, {"model": "PointConvDensityClsSsg(classifier=True) f32"})


def phase_serve_curvenet(rng) -> dict:
    model = from_state(make_curvenet, seeded_state(make_curvenet, rng)).eval()
    return serve_classifier("serve_curvenet", model, CURVE_PER_FORWARD, CLS_SAME_TOL, k15_nearest_first,
                            "CurveNet() (k 20, setting default), 40 classes, f32 eval")


def phase_train_curvenet(rng) -> dict:
    return train_classifier("train_curvenet", make_curvenet, seeded_state(make_curvenet, rng),
                            {"optimizer": "sgd", "lr": CURVE_LR, "momentum": 0.9, "weight_decay": CURVE_WD,
                             "cosine_decay": True, "label_smoothing": CURVE_SMOOTHING, "augment": True},
                            (), CURVE_PER_FORWARD, k15_nearest_first, {"model": "CurveNet() f32"})


def phase_serve_dgcnn_cls(model) -> dict:
    return serve_classifier("serve_dgcnn_cls", model, {"dgcnn_encode_fused": 1}, CLS_BF16_TOL, k5_half_neighbours,
                            "Classifier(DGCNN(1024, k=20)), 40 classes, bf16 eval")


def phase_train_dgcnn_cls(rng) -> dict:
    return train_classifier("train_dgcnn_cls", make_dgcnn_cls, seeded_state(make_dgcnn_cls, rng),
                            {"optimizer": "adam", "lr": TRAIN_LR}, DGCNN_CLS_ZERO_GRADIENT_BIASES,
                            {"knn_neighbors_pallas": 1}, k7_kth_swapped,
                            {"model": "Classifier(DGCNN(1024, k=20)) f32"})


def phase_kernel_cls() -> dict:
    """K8, K14 and K15 at the shapes PointConv and CurveNet give them, on
    the family's SyntheticModelNet40 clouds (B=32, N=1024) and their FPS
    samples, against their plain versions: indices equal (K8's distances
    bit-equal); times, plain, library and bound at each shape."""
    from learning3d_tpu_torch.kernels.knn import knn_pallas, knn_reference
    from learning3d_tpu_torch.kernels.sampling import (ball_query_pallas, ball_query_reference, fps_pallas,
                                                       fps_reference)
    from learning3d_tpu_torch.ops.geometry import index_points

    def times(fn, plain, library, bound_of):
        b_ms, b_by = bound_of
        return {"kernel_ms": cuda_ms(fn), "plain_ms": cuda_ms(plain, reps=1, warmup=1, runs=1),
                "library_ms": None if library is None else cuda_ms(library), "bound_ms": b_ms, "bound_by": b_by}

    x = cls_batch()[0].contiguous()
    k8, k14, k15 = {}, {}, {}
    with torch.inference_mode():
        level = {CLS_N: x}
        for n, npoint in ((CLS_N, 512), (512, 128), (CLS_N, 256), (256, 64)):
            pts = level[n]
            got, want = fps_pallas(pts, npoint), fps_reference(pts, npoint)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"K14 vs plain ({n} -> {npoint}): indices differ")
            level.setdefault(npoint, index_points(pts, got.long()).contiguous())
            k14[f"{n}_to_{npoint}"] = times(lambda: fps_pallas(pts, npoint), lambda: fps_reference(pts, npoint), None,
                                            k14_bound(CLS_B, n, npoint))
        cases = {"curvenet_self": (x, x, DGCNN_CLS_K + 1)}
        for s, k, n in PC_KNN:
            cases[f"pointconv_{s}_among_{n}"] = (level[s], level[n], k)
        for name, (q, p, k) in cases.items():
            (d, i), (want_d, want_i) = knn_pallas(q, p, k), knn_reference(q, p, k)
            torch.cuda.synchronize()
            require(torch.equal(i, want_i) and torch.equal(d, want_d), f"K8 vs plain ({name}): picks or distances")
            k8[name] = times(lambda: knn_pallas(q, p, k), lambda: knn_reference(q, p, k),
                             lambda: library_knn(q, p, k), k8_bound(q, p, k, q is p))
        for n, npoint, radius, nsample in CURVE_POOLS:
            pts, queries = level[n], level[npoint]
            got = ball_query_pallas(radius, nsample, pts, queries, dtype=torch.int64)
            want = ball_query_reference(radius, nsample, pts, queries, dtype=torch.int64)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"K15 vs plain ({npoint} among {n}): indices differ")
            k15[f"{npoint}_among_{n}_r{radius}"] = times(
                lambda: ball_query_pallas(radius, nsample, pts, queries, dtype=torch.int64),
                lambda: ball_query_reference(radius, nsample, pts, queries, dtype=torch.int64),
                lambda: library_ball_query(radius, nsample, pts, queries),
                k15_bound(radius, nsample, pts, queries))
    emit("kernel_cls", tolerance="indices equal (K8's distances bit-equal)", B=CLS_B,
         shapes={"K14": "1024 -> 512 -> 128 (PointConv), 1024 -> 256 -> 64 (CurveNet)",
                 "K8": "21 of 1024 (CurveNet), 32 of 1024 for 512 and 64 of 512 for 128 (PointConv), C = 3",
                 "K15": "256 among 1024 r 0.1 and 64 among 256 r 0.2, 20 each (CurveNet)"},
         knn_pallas=k8, fps_pallas=k14, ball_query_pallas=k15,
         library="torch.cdist + torch.topk (K8), + torch.where (K15); none computes FPS")
    return {"knn_pallas": k8, "fps_pallas": k14, "ball_query_pallas": k15}


GMR_K = 20  # examples/train.py's --nearest_neighbors
M2_NS = 768  # the masknet task's partial source (farthest_subsample_points)
M2_BETA_STD = 0.5  # MaskNet2's attention gates beta, drawn (0 at init: a dead branch)


def make_deepgmr(gen):
    from learning3d_tpu_torch.models import DeepGMR

    return DeepGMR(use_rri=True, nearest_neighbors=GMR_K, generator=gen)


def make_masknet2(gen):
    from learning3d_tpu_torch.models import MaskNet2

    return MaskNet2(generator=gen)


def masknet2_state(rng) -> dict:
    """seeded_state of MaskNet2 with every beta drawn from N(0, M2_BETA_STD)."""
    state = seeded_state(make_masknet2, rng)
    for key, value in state.items():
        if key.endswith("beta"):
            value.copy_(torch.from_numpy(rng.normal(0.0, M2_BETA_STD, value.shape).astype(np.float32)))
    return state


def registration_data(name):
    """The pairs of phases 44 and 45 over the family's SyntheticModelNet40
    clouds (phase 40's, made once): DeepGMR's (clean, for serving), DeepGMR's
    with jittered sources (training), MaskNet2's (a partial source and the
    template's mask)."""
    from learning3d_tpu_torch.data import RegistrationData

    clouds = cls_data().data_class
    if name == "deepgmr":
        return RegistrationData("DeepGMR", clouds)
    if name == "deepgmr_noise":
        return RegistrationData("DeepGMR", clouds, noise=True)
    return RegistrationData("DCP", clouds, partial_source=True, additional_params={"use_masknet": True})


def serve_registration(phase, model, data, check, config) -> dict:
    """One request of CLS_B pairs through InferenceEngine: no kernel
    launched, ``check`` on the output; model_ms and pairs/s. The phase's
    line is printed before its gates are required."""
    from learning3d_tpu_torch.kernels import LAUNCHES, reset_launches
    from learning3d_tpu_torch.serve import InferenceEngine

    template, source = (np.stack([data[i][j] for i in range(CLS_B)]) for j in range(2))
    engine = InferenceEngine(model, batch_size=CLS_B)
    reset_launches()
    out = engine(template, source)
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    inputs = (torch.from_numpy(template).cuda(), torch.from_numpy(source).cuda())
    with torch.inference_mode():
        model_ms = cuda_ms(lambda: model(*inputs), reps=3, warmup=1, runs=1)
    engine(template, source)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine(template, source)
    host_s = time.perf_counter() - t0
    gates = check(out)
    emit(phase, config=config, B=CLS_B, template=list(template.shape[1:]), source=list(source.shape[1:]),
         launches=launches, checks=gates, model_ms=model_ms, engine_ms=1e3 * host_s, pairs_per_s=CLS_B / host_s,
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    require(not launches, f"{phase}: kernels launched {launches} (the model reaches none)")
    for what, ok in gates.items():
        require(ok is not False, f"{phase}: {what}")
    return {"launches": launches, "model_ms": model_ms}


def train_registration(phase, task, make, state, data, config) -> dict:
    """One Adam (TRAIN_LR) step through Trainer.fit on ``task`` (no
    kernel), the checks of check_trained, and the step's parts."""
    import tempfile

    from learning3d_tpu_torch.data import batch_iterator, to_device
    from learning3d_tpu_torch.train import TrainConfig

    batch = to_device(next(batch_iterator(data, CLS_B, seed=SEED)), "cuda")
    with tempfile.TemporaryDirectory() as ckpt:
        cfg = TrainConfig(exp_name=f"chip_smoke_{phase}", task=task, batch_size=CLS_B, num_points=CLS_N,
                          optimizer="adam", lr=TRAIN_LR, epochs=1, masknet_loss="bce", ckpt_dir=ckpt)
        result = train_one_step(phase, cfg, lambda: from_state(make, state), data, batch, 0.0, (), {})
    require(np.isfinite(result["train_loss"]), f"{phase}: loss {result['train_loss']}")
    emit(phase, config={**config, "B": CLS_B, "optimizer": "adam", "lr": TRAIN_LR, "steps": 1, "task": task},
         **result)
    return result


def phase_serve_deepgmr(rng) -> dict:
    model = from_state(make_deepgmr, seeded_state(make_deepgmr, rng)).eval()

    def check(out):
        finite = all(bool(np.isfinite(v).all()) for v in out.values())
        rot = max(rotation_error(out["est_R"]), rotation_error(out["est_R_inverse"]))
        return {"outputs finite": finite, f"est_R, est_R_inverse rotations within {ROT_TOL}": rot <= ROT_TOL,
                "rotation_error": rot, "est_T (32, 4, 4)": out["est_T"].shape == (CLS_B, 4, 4)}

    return serve_registration("serve_deepgmr", model, registration_data("deepgmr"), check,
                              {"model": f"DeepGMR(use_rri=True, nearest_neighbors={GMR_K}) f32 eval, d_model 1024, "
                                         "16 clusters, RRI in the forward"})


def phase_train_deepgmr(rng) -> dict:
    return train_registration("train_deepgmr", "deepgmr", make_deepgmr, seeded_state(make_deepgmr, rng),
                              registration_data("deepgmr_noise"),
                              {"model": f"DeepGMR(use_rri=True, nearest_neighbors={GMR_K}) f32",
                               "data": "RegistrationData('DeepGMR', noise=True)"})


def phase_serve_masknet2(rng) -> dict:
    model = from_state(make_masknet2, masknet2_state(rng)).eval()

    def check(out):
        tmask, smask = out
        return {"masks finite": bool(np.isfinite(tmask).all() and np.isfinite(smask).all()),
                "masks in [0, 1]": bool(((tmask >= 0) & (tmask <= 1)).all() and ((smask >= 0) & (smask <= 1)).all()),
                "shapes": tmask.shape == (CLS_B, CLS_N) and smask.shape == (CLS_B, M2_NS),
                "template_mask_mean": float(tmask.mean()), "template_mask_std": float(tmask.std())}

    return serve_registration("serve_masknet2", model, registration_data("masknet2"), check,
                              {"model": f"MaskNet2() f32 eval, betas drawn from N(0, {M2_BETA_STD})"})


def phase_train_masknet2(rng) -> dict:
    return train_registration("train_masknet2", "masknet", make_masknet2, masknet2_state(rng),
                              registration_data("masknet2"),
                              {"model": f"MaskNet2() f32, betas drawn from N(0, {M2_BETA_STD})", "loss": "bce"})


CLI_B, CLI_SIZE = 32, 64  # the entry points' default batch; --dataset_size 64: two steps and two eval batches
CLI_STEPS = CLI_SIZE // CLI_B
CLI_STARTS = 8  # evaluate --multistart
# r4_pointnet_cls as the r4 recipe trained it (--cosine --augment
# --label_smoothing 0.2 --export_feature), at full width for one epoch
CLI_CLS_ARGS = ["--model", "pointnet", "--task", "classification", "--cosine", "--augment", "--label_smoothing", "0.2",
                "--export_feature"]
CLI_IPC_ARGS = ["--model", "ipcrnet", "--task", "ipcrnet"]
TRAINED = Path(__file__).resolve().parent / "learning3d_tpu_torch" / "trained"
TRAINED_CLS = "r4_pointnet_cls"
TRAINED_N, TRAINED_SIZE = 1024, 2048  # the release's eval set: 64 batches of 32 for the CLI, 8 chunks of 256 served
# The JAX package's figures for the release on the TPU (its manifest's eval
# lines), printed beside the card's for the record, not held to
TPU_MANIFEST = {"accuracy": 0.9761, "int8_acc": 0.9829, "top1_agreement": 0.9883}
# The f32 argmax is held equal to the stored JAX predictions on every cloud
# whose JAX top-1 minus top-2 logit exceeds TRAINED_MARGIN. On the CPU
# (tools/convert_release_torch.py --predictions) the port's f32 logits lie
# within 4.3e-6 of JAX's (largest |logit| 5.8) and every argmax agrees; the
# card sums in another order, so the limit sits 230x above that gap. It
# leaves out one cloud of the 2048 (margin 1.45e-5; the next is 2.2e-3).
TRAINED_MARGIN = 1e-3
# The int8 argmax against JAX's int8 argmax: 2048 of 2048 agree on the CPU
# (the same calibration clouds, the port's plain K2). On the card the
# calibration pass replays the f32 chain in cuBLAS's sum order, so the static
# scales can move by a rounding and a cloud near an int8 tie can flip (JAX's
# own int8 and f32 argmaxes differ on 15 of these clouds); 0.99 allows 20.
TRAINED_INT8_AGREE = 0.99
SWAPPED_CLASSES = (0, 1)  # the control: the head's last layer with these two classes' rows swapped


def run_entry_point(module, argv):
    """``module.main(argv)`` in this process: (its result, its printed
    lines), the lines echoed to stderr (stdout carries the JSON lines)."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = module.main(argv)
    sys.stderr.write(out.getvalue())
    return result, out.getvalue().splitlines()


def printed_metrics(line) -> dict:
    """The numbers of an entry point's line: ``key=value`` tokens (the
    epoch and test lines, the quantized line) or ``key: value`` fields (the
    registration summary)."""
    pairs = re.findall(r"(\w+)=(\S+)", line) or re.findall(r"(\w+): ([^,\s]+)", line)
    return {k: float(v) for k, v in pairs if re.fullmatch(r"-?(\d+\.?\d*(e[-+]?\d+)?|nan|inf)", v)}


def launched() -> dict:
    from learning3d_tpu_torch.kernels import LAUNCHES

    torch.cuda.synchronize()
    return {k: v for k, v in LAUNCHES.items() if v}


def phase_cli_train() -> dict:
    """Phase 46: the port's train CLI twice and its evaluate CLI once, in
    this process, on the card, in a temporary directory."""
    import tempfile

    from learning3d_tpu_torch.examples import evaluate, train
    from learning3d_tpu_torch.kernels import reset_launches

    common = ["--device", "cuda", "--epochs", "1", "--batch_size", str(CLI_B), "--dataset_size", str(CLI_SIZE)]
    # launches the code implies: a classifier step runs K3 in its
    # train-mode pool and K4 in its backward, its f32 eval pass no kernel;
    # each iPCRNet loss (a step or an eval batch) and each multistart
    # batch's rescoring runs K12 twice (both directions)
    want = {"classifier": {"pool_stats_pallas": CLI_STEPS, "pool_bwd_pallas": CLI_STEPS},
            "ipcrnet": {"_nn_oneway_pallas": 2 * (CLI_STEPS + CLI_SIZE // CLI_B)},
            "evaluate": {"_nn_oneway_pallas": 2 * (CLI_SIZE // CLI_B) * 2}}
    runs, gates, lines = {}, {}, {}
    with tempfile.TemporaryDirectory() as ckpt:
        for name, argv, module in (("classifier", CLI_CLS_ARGS + common, train),
                                   ("ipcrnet", CLI_IPC_ARGS + common, train),
                                   ("evaluate", CLI_IPC_ARGS + ["--ckpt", "exp_ipcrnet", "--multistart",
                                                                str(CLI_STARTS)] + common[:2] + common[4:], evaluate)):
            reset_launches()
            t0 = time.perf_counter()
            _, out = run_entry_point(module, argv + ["--ckpt_dir", ckpt])
            runs[name] = {"seconds": time.perf_counter() - t0, "launches": launched()}
            lines[name] = [ln for ln in out if ln.startswith(("epoch", "test_loss=", "Stage:"))]
            values = {k: v for ln in lines[name] for k, v in printed_metrics(ln).items()}
            runs[name]["metrics"] = values
            gates[f"{name}: metrics printed and finite"] = bool(values) and all(np.isfinite(list(values.values())))
            gates[f"{name}: launches {want[name]}"] = runs[name]["launches"] == want[name]
        root = Path(ckpt)
        files = [root / "exp_pointnet" / "run.log", root / "exp_ipcrnet" / "run.log",
                 root / "exp_pointnet" / "feature_model" / "model.pt"] + [
            root / exp / snap / f for exp in ("exp_pointnet", "exp_ipcrnet") for snap in ("best", "latest")
            for f in ("model.pt", "opt.pt", "meta.json")]
        gates["checkpoints, feature model and run.log written"] = all(f.is_file() for f in files)
        gates["evaluate printed the summary line"] = len(lines["evaluate"]) == 2 and \
            lines["evaluate"][1].startswith("Stage: test, Rot_MSE: ")
    emit("cli_train", config={"classifier": " ".join(CLI_CLS_ARGS + common), "ipcrnet": " ".join(CLI_IPC_ARGS + common),
                              "evaluate": f"--ckpt exp_ipcrnet --multistart {CLI_STARTS}",
                              "width": "emb 1024, N=1024 (the scripts' defaults)"},
         steps=CLI_STEPS, want_launches=want, runs=runs, lines=lines, checks=gates)
    for what, ok in gates.items():
        require(ok, f"cli_train: {what}")
    return {"launches": {k: sum(r["launches"].get(k, 0) for r in runs.values())
                         for k in ("pool_stats_pallas", "pool_bwd_pallas", "_nn_oneway_pallas")}}


class StackedClouds:
    """A classification set held as arrays (the items of another, made
    once), so that the controls iterate it without making them again."""

    def __init__(self, clouds, labels):
        self.clouds, self.labels = clouds, labels

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.clouds[i], int(self.labels[i])


def trained_gates(f32, int8, bf16, f32_served, ref, firm) -> dict:
    """The three gates of phase 47 on argmaxes over the eval set: ``f32``
    and ``int8`` against the stored JAX predictions, ``bf16`` (served on
    K1) against ``f32_served``, the port's f32 argmax."""
    agree = float((int8 == ref["pred_int8"]).mean())
    return {f"f32 argmax equal to JAX's on the {int(firm.sum())} clouds of margin > {TRAINED_MARGIN}":
            bool((f32[firm] == ref["pred"][firm]).all()),
            f"int8 argmax agrees with JAX's int8 on >= {TRAINED_INT8_AGREE}": agree >= TRAINED_INT8_AGREE,
            f"bf16 (K1) argmax agrees with the port's f32 on >= {AGREE}": float((bf16 == f32_served).mean()) >= AGREE}


def swapped_head(model):
    """The control: a copy of ``model`` whose logits layer has the rows of
    SWAPPED_CLASSES exchanged."""
    import copy

    bad = copy.deepcopy(model)
    a, b = SWAPPED_CLASSES
    with torch.no_grad():
        for t in (bad.linear3.weight, bad.linear3.bias):
            t[[a, b]] = t[[b, a]].clone()
    return bad


def phase_cli_trained_cls() -> dict:
    """Phase 47: the trained r4_pointnet_cls, converted from the JAX
    release, evaluated by the port's evaluate CLI on the card and served in
    bf16, held to the JAX package's stored predictions."""
    from types import SimpleNamespace

    from learning3d_tpu_torch.data import ClassificationData, SyntheticModelNet40, batch_iterator
    from learning3d_tpu_torch.examples import evaluate
    from learning3d_tpu_torch.examples.train import build_model
    from learning3d_tpu_torch.kernels import reset_launches
    from learning3d_tpu_torch.models import Classifier, PointNet
    from learning3d_tpu_torch.serve import InferenceEngine

    best = TRAINED / TRAINED_CLS / "best"
    # items are made per index, so a smaller set is a prefix of the
    # release's, and its predictions a prefix of the stored ones
    ref = {k: v[:TRAINED_SIZE] for k, v in np.load(best / "reference_predictions.npz").items()}
    argv = ["--model", "pointnet", "--task", "classification", "--ckpt", TRAINED_CLS, "--ckpt_dir", str(TRAINED),
            "--quantize", "--device", "cuda", "--dataset_size", str(TRAINED_SIZE)]
    reset_launches()
    t0 = time.perf_counter()
    result, out = run_entry_point(evaluate, argv)
    cli_s = time.perf_counter() - t0
    cli_launches = launched()
    q = result["quantized"]
    test_line = [ln for ln in out if ln.startswith("test_loss=")]
    q_line = [ln for ln in out if ln.startswith("bf16_acc=")]
    printed = {k: v for ln in test_line + q_line for k, v in printed_metrics(ln).items()}

    t0 = time.perf_counter()
    data = ClassificationData(SyntheticModelNet40(train=False, num_points=TRAINED_N, size=TRAINED_SIZE))
    clouds, labels = (np.concatenate(a) for a in zip(*batch_iterator(data, CLI_B, shuffle=False, seed=0)))
    build_s = time.perf_counter() - t0
    stacked = StackedClouds(clouds, labels.reshape(-1))

    state = torch.load(best / "model.pt", map_location="cpu", weights_only=True)
    bf16 = torch.bfloat16
    served = Classifier(PointNet(emb_dims=EMB, use_bn=True, dtype=bf16), CLASSES, dtype=bf16)
    served.load_state_dict(state)
    served.eval()
    engine = InferenceEngine(served, batch_size=B)
    reset_launches()
    t0 = time.perf_counter()
    logits = engine(clouds)
    serve_s = time.perf_counter() - t0
    serve_launches = launched()
    pred_bf16 = logits.argmax(-1)

    firm = ref["margin"] > TRAINED_MARGIN
    gates = {"the clouds and labels are the stored ones, in order": bool((q["labels"] == ref["labels"]).all() and
                                                                         (stacked.labels == ref["labels"]).all()),
             f"K2 launched once a batch ({TRAINED_SIZE // CLI_B})":
                 cli_launches == {"pointnet_pooled_int8": TRAINED_SIZE // CLI_B},
             f"K1 launched once a chunk ({TRAINED_SIZE // B})":
                 serve_launches == {"pointnet_pooled_kernel": TRAINED_SIZE // B},
             "logits finite": bool(np.isfinite(logits).all()),
             "the two lines printed, their numbers finite": len(test_line) == len(q_line) == 1 and
                 all(np.isfinite(list(printed.values()))),
             **trained_gates(q["pred"], q["pred_int8"], pred_bf16, q["pred"], ref, firm)}

    # the control: every agreement gate must fail with two classes' logit
    # rows swapped (f32 and int8 through the same evaluate function, bf16
    # served), the served one still held to the unswapped f32 argmax
    model = build_model("pointnet", SimpleNamespace(emb_dims=EMB, seed=0), None, "cuda")
    model.load_state_dict(state)
    with contextlib.redirect_stdout(sys.stderr):
        bq = evaluate.evaluate_classification_quantized(swapped_head(model.eval()), stacked,
                                                        SimpleNamespace(batch_size=CLI_B))
    bad_bf16 = InferenceEngine(swapped_head(served), batch_size=B)(clouds).argmax(-1)
    control = trained_gates(bq["pred"], bq["pred_int8"], bad_bf16, q["pred"], ref, firm)
    figures = {"accuracy": q["bf16_acc"], "int8_acc": q["int8_acc"], "top1_agreement": q["top1_agreement"],
               "bf16_served_accuracy": float((pred_bf16 == ref["labels"]).mean())}
    jax_cpu = {"accuracy": float((ref["pred"] == ref["labels"]).mean()),
               "int8_acc": float((ref["pred_int8"] == ref["labels"]).mean()),
               "top1_agreement": float((ref["pred"] == ref["pred_int8"]).mean())}
    emit("cli_trained_cls", release=TRAINED_CLS, argv=" ".join(argv), clouds=int(len(labels)),
         build_clouds_s=build_s, cli_s=cli_s, serve_s=serve_s, clouds_per_s=len(labels) / serve_s,
         printed=printed, card=figures, jax_cpu=jax_cpu, tpu_manifest=TPU_MANIFEST,
         below_margin=int((~firm).sum()), f32_flips_below_margin=int((q["pred"] != ref["pred"])[~firm].sum()),
         f32_flips=int((q["pred"] != ref["pred"]).sum()), int8_flips=int((q["pred_int8"] != ref["pred_int8"]).sum()),
         bf16_vs_f32_flips=int((pred_bf16 != q["pred"]).sum()), launches={**cli_launches, **serve_launches},
         checks=gates, control={"swapped_classes": list(SWAPPED_CLASSES), **control})
    for what, ok in gates.items():
        require(ok, f"cli_trained_cls: {what}")
    for what, ok in control.items():
        require(not ok, f"cli_trained_cls: the control passed {what}")
    return {"launches": {**cli_launches, **serve_launches}}


# -- trained RPMNet and FlowNet3D -----------------------------------------------
TRAINED_RPM, TRAINED_FLOW = "r4b_rpmnet", "r4_flownet"
TRAINED_PAIRS = 16  # the stored results' pairs: the first batch of 16 of each eval set, in order
TRAINED_RPM_SIZE = 2048  # examples/evaluate.py's RegistrationData("RPMNet") over 2048 test clouds with normals
# r4_flownet was trained and evaluated at examples/train.py's and
# evaluate.py's default of 1024 points on SyntheticSceneflow(size=256)
# (its meta.json: synthetic-v2+size256); at 2048 points its radii see twice
# the density, and JAX's own EPE on these pairs is 0.220 against 0.064
TRAINED_FLOW_N, TRAINED_FLOW_SIZE = 1024, 256
# Trained RPMNet's est_T against the plain versions, max |k - p| / max |p|.
# With trained weights beta ~ 100 and alpha ~ 27 put the log-affinities near
# 2,700, where an f32 ulp is 2.4e-4, and the second iteration's grouping of
# the moved source turns a rounding-sized move of the first transform into
# other neighbours on the radius. On the CPU (tools/trained_cpu_gaps.py
# rpmnet, these 16 pairs) K17's correctly rounded output in place of the
# plain version's moved est_T by 4.4e-6 at one iteration and 2.3e-3 at two,
# the plain output moved up one ulp by 2.3e-5 and 1.8e-3. One iteration is
# held at RPM_TOL, two at RPM_TRAINED_TOL, 4x above; the control
# k17_bf16_output moved them 1.0 and 1.6.
RPM_TRAINED_TOL = 1e-2
# est_T on the card against the JAX package's stored CPU est_T, pair by
# pair: max |k - j| over the pair / max |j| over the 16. beta * alpha ~
# 2,800 turns the weight network's rounding of alpha (the two packages sum
# in other orders) into shifts of the log-affinity against the slack's zero.
# On the CPU (tools/trained_cpu_gaps.py rpmnet) the port's plain path lay
# 2.0e-2 from JAX's on pair 4 (2.3e-2 with the kernels' selection
# arithmetic) and at most 4.4e-3 on the other 15 (the median 1.6e-3); on
# the card pair 4 read 2.6e-2 and the rest at most 3.4e-3. So pair 4 is
# named and held at 1e-1, 4x its CPU reading, and the other 15 at 1e-2,
# above both of their worst readings; the control (1.0 to 1.8) must fail
RPM_JAX_TOL = 1e-2
RPM_JAX_FLIPS = {4: 1e-1}  # pair: its limit
# The trained step: the weight network's gradient is the gradient of a
# trained loss with respect to beta and alpha, at a minimum, and rounding
# decides it: on the CPU at one iteration one ulp of the plain Sinkhorn's
# output moved it 41%, K17's correctly rounded output 11%, while the loss
# moved 1e-6 to 8e-6 and PPFNet's gradients 1.9e-4 to 2.1e-4. Its gradients
# are set apart and measured, the rest held to RPM_STEP_TOL. Phase 34, on
# random weights, holds them too and stays the gate of K17's precision
RPM_APART = "weights_net."


def without_apart(run):
    """A (loss, gradients, buffers) step run without the gradients under
    RPM_APART."""
    loss, grads, buffers = run
    return loss, {n: g for n, g in grads.items() if not n.startswith(RPM_APART)}, buffers


def apart_gap(run, ref) -> dict:
    """The largest relative error, |g - g_ref| / |g_ref|, of the gradients
    under RPM_APART in one step run against another, and its tensor."""
    rel, name = max(((g - ref[1][n]).norm().item() / ref[1][n].norm().item(), n)
                    for n, g in run[1].items() if n.startswith(RPM_APART))
    return {"weights_net": rel, "weights_net_tensor": name}
# The trained flow on the card against the JAX package's stored CPU flow,
# max |k - j| / max |j|: FlowNet3D's selections (FPS, ball queries, kNN) read
# the input coordinates only, so rounding cannot flip them; the port's CPU
# path lay 1.2e-5 from JAX's, and so did the CPU path with the kernels'
# selection arithmetic (the same indices on all 16 pairs). The limit is 9x
# that; the control k15_nearest_first must fail it
FLOW_JAX_TOL = 1e-4


@contextlib.contextmanager
def k17_one_ulp_up():
    """Not a control: the plain versions with the plain Sinkhorn's output
    moved up by one f32 ulp (its gradient kept), for the conditioning of
    the trained checks."""
    from learning3d_tpu_torch.kernels import sinkhorn

    def up(la, n_iters=5):
        out = sinkhorn.sinkhorn_slack_reference(la, n_iters)
        return out + (torch.nextafter(out.detach(), torch.full_like(out, float("inf"))) - out.detach())

    with plain_versions():
        sinkhorn.sinkhorn_log_pallas = up
        yield


def trained_pairs(name, ref):
    """The first TRAINED_PAIRS pairs of a release's eval set, rebuilt by the
    port's own data classes (numpy seeds, as the JAX package's), as numpy
    arrays; their ground truth must be the stored one."""
    from learning3d_tpu_torch.data import RegistrationData, SyntheticModelNet40, SyntheticSceneflow

    if name == TRAINED_RPM:
        data = RegistrationData("RPMNet", SyntheticModelNet40(train=False, num_points=RPM_N, size=TRAINED_RPM_SIZE,
                                                              use_normals=True))
    else:
        data = SyntheticSceneflow(npoints=TRAINED_FLOW_N, size=TRAINED_FLOW_SIZE)
    items = [data[i] for i in range(TRAINED_PAIRS)]
    arrays = [np.stack([it[j] for it in items]) for j in range(len(items[0]))]
    truth, want = (arrays[2], ref["igt"]) if name == TRAINED_RPM else (arrays[4], ref["flow_gt"])
    require(np.array_equal(truth, want), f"{name}: the rebuilt pairs' ground truth is the stored one")
    return arrays


def trained_model(name, make):
    """``make()`` with the port checkpoint of ``name`` loaded, in eval mode."""
    model = make()
    model.load_state_dict(torch.load(TRAINED / name / "best" / "model.pt", map_location="cpu", weights_only=True))
    return model.eval()


def max_rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def per_pair_rel(got, want):
    """Each pair's max |got - want| over max |want| of all pairs."""
    return np.abs(got - want).reshape(len(want), -1).max(-1) / np.abs(want).max()


def phase_trained_rpmnet() -> dict:
    """Phase 48: the trained r4b_rpmnet on 16 pairs of its eval set: one
    forward on K16 and K17 held to the plain versions (one iteration at
    RPM_TOL, two at RPM_TRAINED_TOL) and to the JAX package's stored est_T
    pair by pair (RPM_JAX_TOL, RPM_JAX_FLIPS's pair at its own limit), the
    control k17_bf16_output outside each; phase 34's step check at one
    iteration on these weights, the weight network's gradients set apart,
    and the conditioning (one ulp of the plain Sinkhorn's output, two
    iterations) reported."""
    import tempfile

    from learning3d_tpu_torch.kernels import reset_launches
    from learning3d_tpu_torch.models import RPMNet
    from learning3d_tpu_torch.train import TrainConfig, Trainer
    from learning3d_tpu_torch.train.metrics import registration_errors

    t0 = time.perf_counter()
    ref = dict(np.load(TRAINED / TRAINED_RPM / "best" / "reference_predictions.npz"))
    template, source, igt = (torch.from_numpy(a).cuda() for a in trained_pairs(TRAINED_RPM, ref))
    build_s = time.perf_counter() - t0
    model = trained_model(TRAINED_RPM, RPMNet)
    gates = {}
    with torch.inference_mode():
        reset_launches()
        out = model(template, source)
        launches = launched()
        est = out["est_T"].cpu().numpy()
        err = registration_errors(out["est_T"], igt)
        gates[f"launches {RPM_PER_FORWARD}"] = launches == RPM_PER_FORWARD
        gates["est_T, transformed_source and r finite"] = all(bool(torch.isfinite(out[k]).all())
                                                              for k in ("est_T", "transformed_source", "r"))
        gates[f"est_R a rotation within {ROT_TOL}"] = rotation_error(out["est_R"].cpu()) <= ROT_TOL
        one = rpm_gaps(functools.partial(model, max_iterations=1), (template, source), control=k17_bf16_output)
        two = rpm_gaps(model, (template, source), control=k17_bf16_output)
        with k17_one_ulp_up():
            ulp_two = model(template, source)
        with plain_versions():
            plain_two = model(template, source)
        with k17_bf16_output():
            bad = model(template, source)["est_T"].cpu().numpy()
    jax_per_pair, control_jax_per_pair = per_pair_rel(est, ref["est_T"]), per_pair_rel(bad, ref["est_T"])
    jax_limits = np.array([RPM_JAX_FLIPS.get(i, RPM_JAX_TOL) for i in range(TRAINED_PAIRS)])
    gates[f"one iteration: kernels vs plain <= {RPM_TOL}"] = one["rel_gap"] <= RPM_TOL
    gates[f"two iterations: kernels vs plain <= {RPM_TRAINED_TOL}"] = two["rel_gap"] <= RPM_TRAINED_TOL
    gates[f"est_T vs the JAX package's stored CPU est_T, each pair <= {RPM_JAX_TOL} "
          f"(pairs {RPM_JAX_FLIPS} their own)"] = bool((jax_per_pair <= jax_limits).all())
    control = {"one_iteration": one["control_rel_gap"] > RPM_TOL, "two_iterations": two["control_rel_gap"] >
               RPM_TRAINED_TOL, "vs_jax_cpu": bool((control_jax_per_pair > jax_limits).any())}
    ulp = max_rel(ulp_two["est_T"].cpu().numpy(), plain_two["est_T"].cpu().numpy())

    with tempfile.TemporaryDirectory() as ckpt:
        cfg = TrainConfig(exp_name="chip_smoke_trained_rpmnet", task="rpmnet", batch_size=RPM_B, num_points=RPM_N,
                          optimizer="adam", lr=RPM_LR, epochs=1, ckpt_dir=ckpt)

        def make(iterations):
            model = trained_model(TRAINED_RPM, RPMNet).train()
            model.default_iterations = iterations
            return Trainer(cfg, model)

        batch = (template, source, igt)
        runs = step_runs(functools.partial(make, 1), batch, (contextlib.nullcontext, plain_versions, k17_bf16_output))
        held = [without_apart(run) for run in runs]
        step, failed = step_differences(held[0], held[1], RPM_STEP_TOL, (), RPM_NOISE_TOL)
        caught, caught_failed = step_differences(held[2], held[1], RPM_STEP_TOL, (), RPM_NOISE_TOL)
        step.update(apart_gap(runs[0], runs[1]), failed=failed, control={
            "loss": caught["loss"], "grad": caught["grad"], "grad_tensor": caught["grad_tensor"],
            "tensors_failed": len(caught_failed)})
        gates[f"one-iteration step: loss and the gradients but {RPM_APART}'s vs plain <= {RPM_STEP_TOL}"] = (
            np.isfinite(runs[0][0]) and step["loss"] <= RPM_STEP_TOL and not failed)
        control["step"] = bool(caught_failed) or caught["loss"] > RPM_STEP_TOL
        conditioning = {}
        for iterations in (1, 2):
            runs = step_runs(functools.partial(make, iterations), batch, (plain_versions, k17_one_ulp_up) + (
                (contextlib.nullcontext,) if iterations == 2 else ()))
            for label, run in zip(("one_ulp_up", "kernels"), runs[1:]):
                worst, _ = step_differences(without_apart(run), without_apart(runs[0]), RPM_STEP_TOL, (),
                                            RPM_NOISE_TOL)
                conditioning[f"iters_{iterations}_{label}"] = {**{k: worst[k] for k in ("loss", "grad", "grad_tensor")},
                                                               **apart_gap(run, runs[0])}
    card = {"rot_deg": float(err["rot_deg"].mean()), "trans": float(err["trans"].mean())}
    jax_cpu = {"rot_deg": float(ref["rot_deg"].mean()), "trans": float(ref["trans"].mean())}
    emit("trained_rpmnet", release=TRAINED_RPM, pairs=TRAINED_PAIRS, build_pairs_s=build_s,
         dataset=f"RegistrationData('RPMNet', SyntheticModelNet40(train=False, size={TRAINED_RPM_SIZE}, "
                 "use_normals=True)), items 0-15", launches=launches,
         tolerance={"one_iteration_vs_plain": RPM_TOL, "two_iterations_vs_plain": RPM_TRAINED_TOL,
                    "vs_jax_cpu": RPM_JAX_TOL, "vs_jax_cpu_pairs": RPM_JAX_FLIPS,
                    "step": f"loss and every gradient but {RPM_APART}'s {RPM_STEP_TOL} at one iteration"},
         one_iteration=one, two_iterations={**two, "one_ulp_up_rel_gap": ulp},
         jax_rel_gap=float(jax_per_pair.max()), jax_per_pair=jax_per_pair.tolist(),
         control_jax_rel_gap=float(control_jax_per_pair.max()), card=card, jax_cpu=jax_cpu, step_vs_plain=step,
         step_conditioning=conditioning, checks=gates, control={"k17_bf16_output fails": control})
    for what, ok in gates.items():
        require(ok, f"trained_rpmnet: {what}")
    for what, caught in control.items():
        require(caught, f"trained_rpmnet: the control k17_bf16_output passed {what}")
    return {"launches": launches}


def phase_trained_flownet() -> dict:
    """Phase 49: the trained r4_flownet on 16 pairs of its eval set: one
    forward on K14, K15 and K8 held to the plain versions (FLOW_TOL) and to
    the JAX package's stored flow (FLOW_JAX_TOL), the control
    k15_nearest_first outside both; EPE and Acc3D beside JAX's."""
    from learning3d_tpu_torch.kernels import reset_launches
    from learning3d_tpu_torch.models import FlowNet3D

    t0 = time.perf_counter()
    ref = dict(np.load(TRAINED / TRAINED_FLOW / "best" / "reference_predictions.npz"))
    pairs = trained_pairs(TRAINED_FLOW, ref)
    inputs = [torch.from_numpy(a).cuda() for a in pairs[:4]]
    build_s = time.perf_counter() - t0
    model = trained_model(TRAINED_FLOW, FlowNet3D)
    with torch.inference_mode():
        reset_launches()
        flow = model(*inputs)
        launches = launched()
        agree = flow_gaps(model, inputs, control=k15_nearest_first)
        with k15_nearest_first():
            bad = model(*inputs).cpu().numpy()
    flow = flow.cpu().numpy()
    jax_gap, control_jax_gap = max_rel(flow, ref["flow"]), max_rel(bad, ref["flow"])
    gates = {f"launches {FLOW_PER_FORWARD}": launches == FLOW_PER_FORWARD,
             "flow finite": bool(np.isfinite(flow).all()),
             f"kernels vs plain <= {FLOW_TOL}": agree["rel_gap"] <= FLOW_TOL,
             f"flow vs the JAX package's stored CPU flow <= {FLOW_JAX_TOL}": jax_gap <= FLOW_JAX_TOL}
    control = {"plain": agree["control_rel_gap"] > FLOW_TOL, "vs_jax_cpu": control_jax_gap > FLOW_JAX_TOL}
    err = np.linalg.norm(flow - pairs[4], axis=-1)
    rel = err / (np.linalg.norm(pairs[4], axis=-1) + 1e-12)
    card = {"epe": float(err.mean()), "acc3d_strict": float(((err < 0.05) | (rel < 0.05)).mean()),
            "acc3d_relax": float(((err < 0.10) | (rel < 0.10)).mean())}
    emit("trained_flownet", release=TRAINED_FLOW, pairs=TRAINED_PAIRS, build_pairs_s=build_s,
         dataset=f"SyntheticSceneflow(npoints={TRAINED_FLOW_N}, size={TRAINED_FLOW_SIZE}), items 0-15",
         launches=launches, tolerance={"vs_plain": FLOW_TOL, "vs_jax_cpu": FLOW_JAX_TOL}, agree=agree,
         jax_rel_gap=jax_gap, control_jax_rel_gap=control_jax_gap, card=card,
         jax_cpu={k: float(ref[k].mean()) for k in ("epe", "acc3d_strict", "acc3d_relax")}, checks=gates,
         control={"k15_nearest_first fails": control})
    for what, ok in gates.items():
        require(ok, f"trained_flownet: {what}")
    for what, caught in control.items():
        require(caught, f"trained_flownet: the control k15_nearest_first passed {what}")
    return {"launches": launches}


def kernel_entry(name, source, replaces, launches, res) -> dict:
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
        "max_abs_err": res["max_abs_err"], "max_rel_err": res["max_rel_err"],
        "ms": res["kernel_ms"], "kernel_ms": res["kernel_ms"], "plain_ms": res["plain_ms"],
        "bound_ms": res["bound_ms"], "bound_by": res["bound_by"], "library_ms": res["library_ms"],
    }


def main() -> None:
    # No card, or no checkout around the script, fails here before
    # anything is printed.
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from learning3d_tpu_torch.kernels.dgcnn_fused import fold_bn
    from learning3d_tpu_torch.models import DCP, DGCNN, Classifier, PointNet
    from learning3d_tpu_torch.quant import make_fused_quant_forward, quantize_dcp, quantize_pointnet_classifier
    from learning3d_tpu_torch.utils.jax_import import load_nnx_state

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version sums in full f32
    torch.backends.cudnn.allow_tf32 = False
    kind = phase_device()
    # the first torch.optim optimizer imports torch._dynamo (seconds on the
    # card's host): import it while nvcc builds the kernels rather than in
    # the first training phase; joined before anything else imports
    warm = threading.Thread(target=importlib.import_module, args=("torch._dynamo",))
    warm.start()
    phase_build()
    warm.join()

    rng = np.random.default_rng(SEED)
    bf16 = torch.bfloat16
    model = Classifier(PointNet(emb_dims=EMB, use_bn=True, dtype=bf16), CLASSES, dtype=bf16)
    load_nnx_state(model, random_nnx_state(rng, EMB, CLASSES))
    model.eval()
    k1 = phase_kernel(model, rng)
    launches = phase_serve(model, rng)
    calib = torch.from_numpy(rng.normal(size=(CALIB_CLOUDS, N, 3)).astype(np.float32)).cuda()
    fused = make_fused_quant_forward(quantize_pointnet_classifier(model, calib))
    k2 = phase_kernel_k2(fused, rng)
    int8_launches = phase_serve_int8(model, fused, rng)
    del model, fused

    # the PointConv, CurveNet and DGCNN classifier phases draw from a
    # generator of their own; the bf16 DGCNN classifier's encoder is K5's
    # emb 1024 case
    cls_rng = np.random.default_rng(SEED + 17)
    make_bf16 = functools.partial(make_dgcnn_cls, dtype=bf16)
    dgcnn_cls = from_state(make_bf16, seeded_state(make_bf16, cls_rng)).eval()
    dcp = DCP(DGCNN(emb_dims=DCP_EMB, k=DCP_K, dtype=bf16), dtype=bf16)
    load_nnx_state(dcp, random_dcp_state(rng, DCP_EMB))
    dcp.eval()
    with torch.inference_mode():
        wide = [fold_bn(c, bn) for c, bn in zip(dgcnn_cls.feature_model.convs, dgcnn_cls.feature_model.bns)]
    k5 = phase_kernel_k5(dcp, rng, wide)
    del wide
    k6 = phase_kernel_k6(rng)
    dcp_launches = phase_serve_dcp(dcp, rng)
    calib_t, calib_s = (torch.from_numpy(rng.normal(size=(DCP_CALIB_PAIRS, DCP_N, 3)).astype(np.float32)).cuda()
                        for _ in range(2))
    qdcp = quantize_dcp(dcp, calib_t, calib_s, int8_pv=True, fused_layers=False)
    k9 = phase_kernel_k9(qdcp, rng)
    k10 = phase_kernel_k10(rng)
    dcp_int8_launches = phase_serve_dcp_variant("serve_dcp_int8", qdcp, rng, {
        "dgcnn_encode_fused_int8": 2, "attention_int8": 6, "attention_pallas": 1})
    del qdcp

    # bench.py's fused int8 DCP configurations: quantize_dcp's default
    # fused_layers=True, int8 and hybrid P.V; the approx clone is the hybrid
    # one with approx kNN switched on after calibration, as bench.py scopes
    # L3D_APPROX_KNN around the measurement only
    fused = {pv: quantize_dcp(dcp, calib_t, calib_s, int8_pv=pv, fused_layers=True) for pv in (True, False)}
    approx = quantize_dcp(dcp, calib_t, calib_s, int8_pv=False, fused_layers=True)
    approx.emb_nn.approx_knn = True
    with torch.inference_mode():
        feats = [fused[True].emb_nn(torch.from_numpy(rng.normal(size=(DCP_B, DCP_N, 3)).astype(np.float32)).cuda())
                 for _ in range(2)]
    k11 = phase_kernel_k11({pv: (q.pointer.enc_layers[0], q.pointer.dec_layers[0]) for pv, q in fused.items()},
                           feats)
    del feats
    per_chunk = {"dgcnn_encode_fused_int8": 2, "encoder_layer_int8": 2, "decoder_layer_int8": 2,
                 "attention_pallas": 1}
    fused_launches = phase_serve_dcp_variant("serve_dcp_int8_fused", fused[True], rng, per_chunk, FUSED_REQUESTS)
    phase_serve_dcp_variant("serve_dcp_int8_hybrid_fused", fused[False], rng, per_chunk, FUSED_REQUESTS,
                            served=HYBRID_SERVED)
    share = phase_approx_kernels(dcp, approx, rng)["share"]
    phase_serve_dcp_variant("serve_dcp_int8_hybrid_fused_approx", approx, rng, per_chunk, FUSED_REQUESTS,
                            served=HYBRID_SERVED,
                            picks_differing_from_exact=share)
    phase_serve_dcp_variant("serve_template", fused[False], rng, {**per_chunk, "dgcnn_encode_fused_int8": 1},
                            FUSED_REQUESTS, template=True, served=HYBRID_SERVED)
    del fused, approx, dcp

    k3, k3_cases = phase_kernel_k3(rng)
    k4 = phase_kernel_k4(rng, k3_cases)
    del k3_cases
    train = phase_train(rng)
    k7 = phase_kernel_k7(rng)
    train_dcp = phase_train_dcp(rng)
    k12 = phase_kernel_k12(rng)
    k13 = phase_kernel_k13(rng)
    serve_ipc = phase_serve_ipcrnet(rng)
    train_ipc = phase_train_ipcrnet(rng)
    train_pcn = phase_train_pcn(rng)
    k12_launches = serve_ipc["multistart_launches"]["_nn_oneway_pallas"] + train_ipc["launches"] + \
        train_pcn["launches"]["coarse_fit"] + train_pcn["launches"]["detailed_step"]
    k8 = phase_kernel_k8(rng)
    serve_prnet = phase_serve_prnet(rng)
    train_prnet = phase_train_prnet(rng)
    flow_rng = np.random.default_rng(SEED + 12)
    with torch.inference_mode():
        levels = {name: flow_levels(torch.from_numpy(a).cuda()) for name, a in
                  zip(("pc1", "pc2"), flow_requests(FLOW_B)[:2])}
    k14 = phase_kernel_k14(flow_rng, levels)
    k15 = phase_kernel_k15(flow_rng, levels)
    del levels
    serve_flownet = phase_serve_flownet(flow_rng)
    train_flownet = phase_train_flownet(flow_rng)
    k8_launches = serve_prnet["launches"]["knn_pallas"] + serve_prnet["multistart_launches"]["knn_pallas"] + \
        train_prnet["launches"]["knn_pallas"] + serve_flownet["launches"]["knn_pallas"] + \
        train_flownet["launches"]["knn_pallas"]
    rpm_rng = np.random.default_rng(SEED + 13)
    k16 = phase_kernel_k16(rpm_rng)
    k17 = phase_kernel_k17(rpm_rng)
    serve_rpmnet = phase_serve_rpmnet(rpm_rng)
    train_rpmnet = phase_train_rpmnet(rpm_rng)
    lk_rng = np.random.default_rng(SEED + 14)
    serve_lk = phase_serve_masknet_pnlk(lk_rng)
    train_pnlk = phase_train_pnlk(lk_rng)
    train_masknet = phase_train_masknet(lk_rng)
    phase_train_seg(lk_rng)
    pool_f32 = phase_kernel_pool_f32(np.random.default_rng(SEED + 15))
    k3["max_abs_err"] = max(k3["max_abs_err"], pool_f32["k3_abs"])
    k3["max_rel_err"] = max(k3["max_rel_err"], pool_f32["k3_rel"])
    k4["max_abs_err"] = max(k4["max_abs_err"], pool_f32["k4_abs"])
    k4["max_rel_err"] = max(k4["max_rel_err"], pool_f32["k4_rel"])
    phase_kernel_cls()
    serve_pc = phase_serve_pointconv(cls_rng)
    train_pc = phase_train_pointconv(cls_rng)
    serve_cn = phase_serve_curvenet(cls_rng)
    train_cn = phase_train_curvenet(cls_rng)
    serve_dg = phase_serve_dgcnn_cls(dgcnn_cls)
    del dgcnn_cls
    train_dg = phase_train_dgcnn_cls(cls_rng)
    gmr_rng = np.random.default_rng(SEED + 18)
    phase_serve_deepgmr(gmr_rng)
    phase_train_deepgmr(gmr_rng)
    m2_rng = np.random.default_rng(SEED + 19)
    phase_serve_masknet2(m2_rng)
    phase_train_masknet2(m2_rng)
    cli = phase_cli_train()["launches"]
    trained = phase_cli_trained_cls()["launches"]
    trained_rpm = phase_trained_rpmnet()["launches"]
    trained_flow = phase_trained_flownet()["launches"]
    family = (serve_pc, train_pc, serve_cn, train_cn, serve_dg, train_dg)
    added = {name: sum(r["launches"].get(name, 0) for r in family) for name in (
        "dgcnn_encode_fused", "knn_neighbors_pallas", "knn_pallas", "fps_pallas", "ball_query_pallas")}
    k3_launches = train["launches"]["pool_stats_pallas"] + train_pnlk["launches"]["pool_stats_pallas"] + \
        train_masknet["launches"]["pool_stats_pallas"] + cli["pool_stats_pallas"]
    k4_launches = train["launches"]["pool_bwd_pallas"] + train_masknet["launches"]["pool_bwd_pallas"] + \
        cli["pool_bwd_pallas"]

    csrc = "learning3d_tpu_torch/kernels/csrc/"
    print(json.dumps({"kernels": [
        kernel_entry("pointnet_pooled_kernel", csrc + "pointnet_fused.cu",
                     "learning3d_tpu/kernels/pointnet_fused.py:205",
                     launches + serve_lk["launches"] + trained["pointnet_pooled_kernel"], k1),
        kernel_entry("dgcnn_encode_fused", csrc + "dgcnn_fused.cu",
                     "learning3d_tpu/kernels/dgcnn_fused.py:205",
                     dcp_launches["dgcnn_encode_fused"] + added["dgcnn_encode_fused"], k5),
        kernel_entry("attention_pallas", csrc + "attention.cu",
                     "learning3d_tpu/kernels/attention.py:61", dcp_launches["attention_pallas"], k6),
        kernel_entry("pointnet_pooled_int8", csrc + "pointnet_int8.cu",
                     "learning3d_tpu/kernels/pointnet_fused.py:128", int8_launches + trained["pointnet_pooled_int8"],
                     k2),
        kernel_entry("dgcnn_encode_fused_int8", csrc + "dgcnn_int8.cu",
                     "learning3d_tpu/kernels/dgcnn_fused.py:455", dcp_int8_launches["dgcnn_encode_fused_int8"], k9),
        kernel_entry("attention_int8", csrc + "attention_int8.cu",
                     "learning3d_tpu/kernels/attention.py:222", dcp_int8_launches["attention_int8"], k10),
        kernel_entry("encoder_layer_int8", csrc + "transformer_int8.cu",
                     "learning3d_tpu/kernels/transformer_int8.py:274", fused_launches["encoder_layer_int8"],
                     k11["encoder"]),
        kernel_entry("decoder_layer_int8", csrc + "transformer_int8.cu",
                     "learning3d_tpu/kernels/transformer_int8.py:289", fused_launches["decoder_layer_int8"],
                     k11["decoder"]),
        kernel_entry("pool_stats_pallas", csrc + "poolgrad.cu", "learning3d_tpu/kernels/poolgrad.py:146",
                     k3_launches, k3),
        kernel_entry("pool_bwd_pallas", csrc + "poolgrad.cu", "learning3d_tpu/kernels/poolgrad.py:203",
                     k4_launches, k4),
        kernel_entry("knn_neighbors_pallas", csrc + "dgcnn_select.cu", "learning3d_tpu/kernels/edgeconv.py:73",
                     train_dcp["launches"]["knn_neighbors_pallas"] + added["knn_neighbors_pallas"], k7),
        kernel_entry("_nn_oneway_pallas", csrc + "chamfer.cu", "learning3d_tpu/kernels/chamfer.py:65",
                     k12_launches + cli["_nn_oneway_pallas"], k12),
        kernel_entry("_emd_fwd_pallas", csrc + "emd.cu", "learning3d_tpu/kernels/emd.py:264",
                     train_pcn["launches"]["emd"], k13),
        kernel_entry("knn_pallas", csrc + "knn.cu", "learning3d_tpu/kernels/knn.py:192",
                     k8_launches + added["knn_pallas"] + trained_flow["knn_pallas"], k8),
        kernel_entry("fps_pallas", csrc + "fps.cu", "learning3d_tpu/kernels/sampling.py:68",
                     serve_flownet["launches"]["fps_pallas"] + train_flownet["launches"]["fps_pallas"] +
                     added["fps_pallas"] + trained_flow["fps_pallas"], k14),
        kernel_entry("ball_query_pallas", csrc + "ball_query.cu", "learning3d_tpu/kernels/sampling.py:264",
                     serve_flownet["launches"]["ball_query_pallas"] + train_flownet["launches"]["ball_query_pallas"] +
                     added["ball_query_pallas"] + trained_flow["ball_query_pallas"], k15),
        kernel_entry("ball_group_pallas", csrc + "ball_group.cu", "learning3d_tpu/kernels/sampling.py:183",
                     serve_rpmnet["launches"]["ball_group_pallas"] + train_rpmnet["launches"]["ball_group_pallas"] +
                     trained_rpm["ball_group_pallas"], k16),
        kernel_entry("sinkhorn_log_pallas", csrc + "sinkhorn.cu", "learning3d_tpu/kernels/sinkhorn.py:52",
                     serve_rpmnet["launches"]["sinkhorn_log_pallas"] +
                     train_rpmnet["launches"]["sinkhorn_log_pallas"] + trained_rpm["sinkhorn_log_pallas"], k17),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
