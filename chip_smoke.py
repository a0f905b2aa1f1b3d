#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``triton_client_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phase ensemble     # one group of phases (repeatable)

``--phase NAME`` runs phase 1 and the named groups (``PHASES``: yolov5,
3d, second, ragged, dense_batched, graphs, driver, facade, layout, remote,
centerpoint, precision, replay, detectron_v4, ensemble, loadgen,
second_sparse, telemetry, telemetry_plane, lifecycle, sessions, router), with the
groups whose served models they reuse, or whose kernel rows they add to,
run first; an unknown name exits 2.
A named run ends as a whole run does, with the ``{"kernels": [...]}``
record (the rows of the kernels its groups measured) and the ``{"ok":
true, ...}`` line.

It builds the hand-written CUDA kernels from ``triton_client_tpu_torch/
csrc/`` and drives the port's four main paths, each served in-process
through ``ModelRepository`` and ``CUDAChannel`` (each pipeline captured as
CUDA graphs at registration) with random weights from a seed: YOLOv5n at 512x512 (the settings of ``examples/yolov5_crop_base``),
PointPillars at the full KITTI width (``examples/pointpillar_kitti``),
SECOND-IoU with the dense middle at the full KITTI width
(``examples/second_iou``, the 352 x 400 x 10 grid), and the continuous
batcher in front of the channel: packed ragged batches of KITTI-sized
clouds through the pool model (``models/pool.py``), and YOLOv5n through its
dense merged path; then the KServe v2 façade over a disk repository of the
same three entries, the layout and precision of examples/yolov5_crop (phase
26), detect2d/detect3d client processes against serve (phase 27), and
CenterPoint with velocity on nuScenes at full width with 10-sweep
aggregation, with examples/pointpillar_wide beside it (phase 28), and every
serving precision policy on every served family (phase 29), replay
and evaluation from bags (phase 30), YOLOv4, RetinaNet and FCOS from disk
(phase 31), server-side preprocess and ensembles (phase 32), the load
generator against `serve` (phase 33), SECOND-IoU's sparse middle at the
reference's 0.05 m grid (phase 34) and the measurement units: the
device-time ledger, the roofline, op attribution and the tools (phase 35),
the telemetry and SLO planes behind serve (phase 36), the model
lifecycle and tenant plane (phase 37), streaming sessions with the
tracker on the card (phase 38) and the front-door router over two serve
replicas (phase 39).
One JSON line per phase:

  1. card      — the card's name and power limit, the kernels' build time
  2. kernels   — each kernel against its plain PyTorch version on the card,
                 at the main path's shapes, over edge-case candidate sets
                 (live NaN scores included), in and out of score order (the
                 two branches of kernels 1 and 2's order passes, read back
                 from their workspaces and counted), and up to the largest
                 K the wrappers take (kernel 2 also at the reference's
                 16,128-box YOLO head): bitwise equal or the script fails
  3. main_path — requests at batch 1 and 8 through the channel, fused and
                 unfused routes; launch counts read around this phase only
  4. check     — the card's output against the plain tail and the CPU path
  5. times     — each kernel's device time (CUDA events around launches
                 queued behind a sleep kernel), its wrapper's call time
                 and its plain version's (CUDA events), frames/s
                 and p50 latency at batch 1 and 8, and of the unfused
                 conf-0.05 route at batch 8 with and without
                 TRITON_CLIENT_TPU_NMS=pallas; on the lines before it,
                 kernels 1 and 2's time by pass (torch.profiler) and the
                 bytes of the workspace a call allocated
  6. profile   — where a request's time goes, under torch.profiler: device
                 ms and busy share per request, device ops per request,
                 the device ops that took the most time, at batch 1 and 8
  7. kernels_vs_plain_3d — the 3D decode and suppress+pack kernels against
                 their plain versions at B = 1, K = 256, max_det 128, over
                 edge cases (ops/kernel_cases.py; the decode in both forms,
                 the gathered one reading 256 of the KITTI head's 321,408
                 anchors, with tied and NaN direction logits), sorted and
                 shuffled (the order path read back as in phase 2), and
                 kernel 4 up to the largest K the wrapper takes
  8. main_path_3d — scans of 20,000 and 120,000 points through the channel,
                 fused and unfused routes; launch counts read around this
                 phase only (kernel 3 in its gathered form on every fused
                 request)
  9. check_3d  — the kernels on the main path's own candidates (kernel 3
                 in both forms, on the head and top-k indices), the card
                 against the CPU path at a tiny grid, the cells of NaN,
                 +-inf, +-1e10 and +-2^31 coordinates on the card against
                 the CPU, and a NaN point keeping no detection on either
 10. times_3d  — the 3D kernels' and plain versions' times (kernel 3 in
                 both forms), scans/s and p50 latency at 20k and 120k
                 points; on the line before it, kernel 4's time by pass and
                 its workspace
 11. profile_3d — phase 6 for a 120k-point scan, and the fused route's
                 stage from the top-k indices to the boxes as it runs (one
                 gathered launch) and as it ran (four gathers, then the
                 kernel): device ops, device ms and host ms a call
 12. kernels_vs_plain_second — the sorted-segment mean against its plain
                 version, bitwise, at N = 131,072 rows and 40,000 slots over
                 edge cases (ops/kernel_cases.py SEGMENT_KINDS)
 13. main_path_second — 20,000- and 120,000-point scans through the channel,
                 fused (voxel stage + 3D tail) and unfused routes; launch
                 counts read around this phase only; occupied and kept cells
 14. check_second — the three kernels on the main path's own inputs (kernel
                 3 in both forms), and the
                 card against the CPU path at a tiny grid
 15. times_second — the segment mean's times, bound and library yardstick,
                 scans/s and p50 latency at 20k and 120k points; on the
                 line before it, its two launches' times (zero, walk)
 16. profile_second — phase 6 for a 120k-point SECOND scan
 17. kernels_vs_plain_ragged — the segment sum (kernel 6) against its plain
                 version, bitwise, over edge cases (ops/kernel_cases.py
                 SEGSUM_CASES: sorted layout ids with the pad id, unsorted,
                 out-of-range, empty segments, one segment; F up to 130, S up
                 to 64, R from 1 to 560,000), and segment_reduce's four ops
                 on the card against the same call on CPU copies
 18. main_path_ragged — 8 seeded KITTI-sized clouds (20,000-120,000 points)
                 through ContinuousBatchingChannel(CUDAChannel(repo)) as one
                 packed group and as a threaded burst of 8 callers, the packed
                 route captured as CUDA graphs (one a segment bucket and
                 packed-row bucket, each owning its kernel-6 tickets; the
                 graphs the run needs are captured before the counted window);
                 launch counts read around this phase only (kernel 6 counted
                 inside replays, one a packed batch), the ragged_* stats, the
                 pool model's solo infer_fn calls (0 in the packed group: no
                 silent fallback), and every packed batch's output bitwise
                 equal to the eager route's on the same packed request
 19. check_ragged — kernel 6 on the main path's own packed rows, each
                 member against a float64 sum, packed and solo, and the card
                 against the CPU port on the same group
 20. times_ragged — kernel 6's times, its one launch's profiler time,
                 bound and index_add_ yardstick; clouds/s and p50 through
                 the batcher, captured against eager (rounds interleaved; a
                 round in which a capture happened is discarded and rerun),
                 beside solo requests
 21. dense_batched_2d — YOLOv5n 512^2 frames through the same scheduler's
                 dense merged path: a group of 8 one-frame requests equals one
                 direct call on the 8 frames stacked, bit for bit
 22. graphs    — each served path as the CUDA graph its pipeline captured
                 at registration (runtime/graphs, the port's jax.jit):
                 YOLOv5n (conf 0.05) at batch 1 and 8, fused, unfused (the
                 fixpoint NMS, a loop the capture cuts in three graphs) and
                 unfused under TRITON_CLIENT_TPU_NMS=pallas, PointPillars and
                 SECOND-IoU fused and unfused at 20k and 120k points. The
                 captured call is bitwise equal to the eager body; each
                 kernel's launches through 5 replays are 5 times one eager
                 call's; a replay on a second input gives that input's
                 result; two requests in flight at pipeline_depth 2, resolved
                 in reverse order, each get their own; no request captures
                 after the registration warmup. Captures, keys and pool bytes
                 per model
 23. times_graphs — the same paths through CUDAChannel, the eager body
                 (registered as the model's infer_fn) against the captured
                 one on the same requests, eager / captured / eager /
                 captured: p50 and frames/s or scans/s; at YOLOv5n batch 1 and
                 PointPillars 120k also the device ops the host issued a
                 request (torch.profiler: cudaGraphLaunch and the copies
                 around it, or every kernel launch) and the busy share
 24. driver    — InferenceDriver over CUDAChannel: 64 seeded 512^2 frames
                 (YOLOv5n conf 0.05) sync, with 2 futures in flight and at
                 batch 8, and 16 seeded clouds (PointPillars) sync and with 2
                 in flight: frames/s and p50 each, the async results bitwise
                 equal to the sync ones frame by frame, batch 8 within 1e-5
                 of batch 1 on every live row
 25. facade    — the KServe v2 façade over a disk repository: scan_disk of
                 copies of examples/yolov5_crop_base, pointpillar_kitti and
                 second_iou (config.yaml only; data/ read from the checkout
                 with yaml_subset) and of the YOLOv5n entry at conf 0.05,
                 served by CUDAChannel with each entry's graphs captured at
                 registration; the server's _Servicer answers every RPC
                 in-process on request bytes (service.invoke): health,
                 metadata, ModelConfig, RepositoryIndex; ModelInfer for
                 YOLOv5n at batch 1 and 8 and both 3D entries at 20k and
                 120k points, each output bitwise equal to
                 CUDAChannel.do_inference; ModelStreamInfer of 8 requests at
                 depth 2, in order, each its own request's result; NOT_FOUND
                 and INVALID_ARGUMENT; kernels 1, 3, 4 and 5 launched once a
                 fused request inside the phase. p50 and frames/s or scans/s
                 through the servicer against the direct channel (YOLOv5n b1,
                 PointPillars 120k) and the servicer's own host ms a request.
                 Where grpc imports, InferenceServer on a loopback port
                 repeats the ModelInfer checks through the port's GRPCChannel
                 ("grpc": true; otherwise "grpc": false and no socket leg)
 26. layout    — the layout and precision of examples/yolov5_crop: scan_disk
                 of yolov5_crop (s2d stem, ch_floor 32, bf16 body),
                 yolov5_crop_mxu, yolov5l_crop (YOLOv5l at full width) and
                 yolov5_crop_base, each as it stands (conf 0.3) and at conf
                 0.05, from a seeded upstream checkpoint of its variant in
                 its version dirs (1/weights.pt; the conf-0.05 copies also
                 2/weights.onnx of the same tensors), and PointPillars and
                 SECOND-IoU from 1/weights.pth; every entry and version at
                 batch 1 and 8 and a 20k scan a 3D entry through the
                 servicer, bitwise equal to CUDAChannel.do_inference, with
                 kernel 1 launched once a 2D request (3, 4, 5 on the 3D
                 ones) and no capture inside the counted window;
                 weights.pt = weights.onnx = load_pipeline in-process, and
                 captured = eager, bit for bit at batch 1 and 8;
                 yolov5_crop_base under precision="bf16" (staged as
                 torch.bfloat16, detections float32, the host down-cast's
                 ms; its conf-0.05 copy's detections at batch 1 and 8
                 scored against the f32 entry's, at least the f32
                 self-score less MAP_BUDGETS["bf16"]); for YOLOv5n and
                 YOLOv5l the s2d/ch_floor f32 heads within 5e-4 of the
                 plain ones and the bf16 s2d/ch_floor
                 detections' mAP against the plain f32 ones at least the
                 f32 self-score less MAP_BUDGETS["bf16"]; p50 and frames/s
                 of each conf-0.05 entry at batch 1 and 8, param_bytes and
                 graph-pool bytes
 27. remote    — the reference's own shape of run: `serve`
                 (cli/serve.build_server in this process, loopback TCP and
                 --uds auto) over copies of examples/yolov5_crop, its
                 conf-0.05 copy and pointpillar_kitti with seeded upstream
                 weights, and client processes with no card visible:
                 detect2d -m yolov5_crop_c005 -i synthetic:64:512x512 at -b 1,
                 -b 8 and --async --inflight 2, and detect3d over 16 seeded
                 120k-point clouds, each over the wire (--no-shm), --shm and
                 grpc:unix: (auto -> shm). Every client's detections.jsonl
                 rows equal the in-process detect2d/detect3d -r run's (its own
                 process, on the card), bit for bit; each report names its
                 transport; kernel 1 once a 2D request, kernels 3 and 4 once a
                 3D request inside the counted window, no capture in it;
                 ServerMetadata lists system_shared_memory. Frames/s and p50
                 a client and transport beside phase 25's socket leg, the
                 size of /dev/shm, and the wire split of YOLOv5 batch 1 and
                 PointPillars 120k on each transport (client encode, the
                 wire: the RPC beyond the server's wall, the server's wall
                 from its span summary, client decode; traced
                 GRPCChannel.do_inference calls, which graft the summary
                 with obs/trace.graft_span_summary), from this process and
                 from a client process; the host time of the servicer's
                 q8/q16 dequantization at batch-8 512² frames and a 120k
                 cloud
 28. centerpoint — examples/centerpoint_nusc (data/nusc_centerpoint.yaml:
                 the 512 x 512 canvas, 5 point features, buckets 131,072
                 and 262,144) from a seeded det3d-named weights.pth with a
                 shared-conv bias (runtime/importers.load_centerpoint, no
                 JAX), and examples/pointpillar_wide, behind serve in this
                 process. Scans: 10 seeded sweeps of 26,000 points over the
                 nuScenes range, 0.05 s apart, moved into the keyframe by a
                 pose JSONL (260,000 points), and single 30,000-point
                 sweeps. Lines centerpoint_kernel4 (kernel 4 bitwise equal
                 to its plain version on the main path's own K = 128
                 candidates of 11 columns, captured = eager bitwise with
                 equal launches at both buckets), centerpoint_main_path
                 (13 scans through CUDAChannel: one kernel 4 launch each and
                 no other, no capture in the window, rows bitwise equal to
                 the in-process pipeline's, the card against the CPU
                 pipeline with rows matched by box), centerpoint_times (p50
                 and scans/s at both buckets, device ms, busy share and
                 top ops, stable_top_k over 655,360 entries, kernel 4's
                 ms/call/plain/bound at this shape, pointpillar_wide's p50)
                 and centerpoint_remote (detect3d -u grpc: --sweeps 10
                 --poses clients with no card over the wire, shm and the
                 unix socket, rows bitwise equal to the in-process -r run
                 and carrying pred_velocities; kernel 4 once a request)
 29. precision — scan_disk(..., precision=...) of examples/pointpillar_kitti,
                 second_iou and centerpoint_nusc (seeded) at f32, bf16 and
                 int8w, and of yolov5_crop_base (conf 0.05) at f32, int8w
                 and a calibrated int8, the same weights under every policy;
                 lines precision_3d (one an entry), precision_2d and
                 precision. For each entry and policy: kernels 1, 3, 4 and 5
                 bitwise equal to their plain versions on the path's own
                 inputs, captured = eager bitwise, one launch of each of the
                 path's kernels a request through CUDAChannel with the counts
                 set to 0 just before each path and read just after and no
                 capture in the window, points staged float32 and the int8
                 entry's images int8 (bytes a request), the card against the
                 CPU port at a tiny grid (bf16 heads within twice the CPU's
                 own bf16 distance) and the policy's detections there within
                 MAP_BUDGETS of f32's; the full-width mAP against f32
                 (reported), p50 and scans/s or frames/s, device ms, busy
                 share and top device ops (torch.profiler), param_bytes and
                 graph-pool bytes; the phase's wall time
 30. replay    — bags written from a seed with io/synthdata in a temporary
                 directory: 32 rgb8 512² frames with their GT, 8 KITTI
                 scans of ~120,000 points (uncompressed and bz2) and 20
                 nuScenes sweeps of ~30,000 points with an Odometry topic.
                 detect2d -i <bag> on yolov5_crop's conf-0.05 copy with
                 --gt (in-process, and as a remote client of serve with no
                 card, running evaluate where prometheus_client is
                 installed: its /metrics scraped once, then SIGINT), detect3d
                 -i <bag> on pointpillar_kitti (jsonl, bz2, --sink bag) and
                 detect3d -i <bag> --sweeps 10 --poses odom on
                 centerpoint_nusc. Rows from a bag equal, bit for bit, those
                 of the same frames from an image directory and of the clouds
                 pc-extract makes of the bag (CenterPoint: --poses <jsonl> at
                 the bag's period); the output bag holds the rows' boxes; the
                 evaluator's summary and Summaries equal eval/detection_map
                 on the rows; kernels 1, 3 and 4 launch once a request. Lines
                 replay_legs (which legs ran, which package was missing) and
                 replay: frames/s and scans/s from a bag against an image
                 directory and .npy replay, host ms a message to read and
                 decode, the phase's wall time
 31. detectron_v4 — examples/yolov4_coco (CSPDarknet53, 512², 80 classes;
                 a seeded pytorch-YOLOv4-named weights.pth through its
                 importer), examples/retinanet_coco (ResNet-50 FPN, 480x640,
                 80 classes; a seeded detectron2-named weights.pth) and
                 examples/fcos_crop (ResNet-50 FPN, 480x640, 2 classes;
                 seeded) from a disk repository through scan_disk,
                 ModelRepository and CUDAChannel, captured, beside
                 yolov4_coco at conf 0.2 (seeded obj * cls sits at ~0.25,
                 under the entry's 0.4; RetinaNet and FCOS fill K = 1024 at
                 their own 0.05). Kernel 1 bitwise against its plain version
                 on each path's own candidates (the scored tail: multi-label
                 xyxy, class-aware, max_det 100); captured equal to eager;
                 the card's rows against the port's CPU rows on the same
                 weights; one kernel-1 launch a request in a counted window;
                 _Servicer responses bitwise equal to CUDAChannel's (INT64
                 classes, INT32 dims); one detect2d -u grpc: client process
                 against the YOLOv4 copy bitwise equal to the in-process -r
                 run. Lines detectron_v4_kernel (kernel 1 and the stable sort
                 at the scored shapes) and detectron_v4: GFLOPs a frame, p50
                 and frames/s at batch 1 and 4, device ms, busy share and top
                 device ops a request, graph-pool bytes, the wall time
 32. ensemble  — scan_disk of examples/camera_preprocess, yolov5_crop (at
                 conf 0.05: seeded weights keep nothing at 0.3),
                 yolov5_crop_base, ensemble_crop_pipeline and
                 ensemble_fused_pipeline, and a fuse: never copy of the fused
                 one, served by CUDAChannel; a device-resident DAG (the fused
                 ensemble, then a host-only member registered here). Seeded
                 480x640 frames at batch 1 and 8: the fused DAG (one CUDA
                 graph over preprocess and yolov5_crop, kernel 1 inside it)
                 equals the host path, the chain run by hand through the
                 channel, ensemble_crop_pipeline and the mixed DAG, rows bit
                 for bit; one kernel-1 launch a fused request counted
                 through graph replays and no other kernel, no capture in
                 the counted window. p50, frames/s, device ms, host-device
                 bytes a request and graph-pool bytes of the fused, host and
                 hand-chained paths, and the fused warmup's 64x64 graph
 33. loadgen   — `serve` over the phase-32 repository in a process of its
                 own, and utils/loadgen on loopback against yolov5_crop and
                 ensemble_fused_pipeline: run_pool with 4 clients for 1.5 s in
                 the unary, stream and async modes, run_open_loop at half
                 the unary frames/s for 1.5 s, slo_capacity_search at a 33 ms
                 SLO with 2 s probes and 4 bisections; frames/s, p50, p99,
                 errors (none allowed) and capacity
 34. second_sparse — SECOND-IoU with the sparse middle built from
                 data/kitti_second_sparse005.yaml (1408 x 1600 x 40 cells,
                 seeded, full width) on phases 12-16's synthetic scans of
                 20,000 and 120,000 points. Lines second_sparse_levels (each
                 sparse level's live sites against its budget and whether the
                 cap bound, the card's sites equal to the CPU's; the captured
                 body bitwise equal to the eager one at both buckets, an eager
                 scan launching kernels 3 and 4 once and kernel 5 never),
                 second_sparse_check (the card's rows against the port's CPU
                 rows on the same weights: the tests' golden config at 1e-5
                 and full width at SPARSE_FULL_TOL, labels and order equal;
                 the heads' largest difference), second_sparse_main_path
                 (scans through CUDAChannel: one launch of kernels 3 and 4 a
                 request and no other, no capture in the window, rows equal
                 to the in-process pipeline's bit for bit),
                 second_sparse_times (p50 and scans/s over 50 captured
                 requests a size, device ms, busy share and top device ops a
                 request, the sparse VFE's and the middle's own device ms,
                 the graph pool's bytes) and second_sparse_cli (detect3d
                 --config in-process equal, row for row, to a detect3d -u
                 grpc: client process with no card against serve over a
                 disk entry whose dataset: is the YAML; its launches)
 35. telemetry — the measurement units (obs/device_time, obs/roofline,
                 obs/opstats and the trace-dump / roofline tools) on
                 examples/yolov5_crop, pointpillar_kitti and second_iou
                 served from a disk repository through CUDAChannel: 20
                 requests each without and with a DeviceTimeLedger and 20
                 under torch.profiler. Held: one ledger launch a request,
                 each CUDA-event window within its request's wall,
                 flops_per_call equal to the network's FlopCounterMode count,
                 the kernel time opstats attributes to a model at most its
                 ledger time + 2%, kernels 1, 3, 4 and 5 under their models
                 with occurrences equal to launches, under 5% of device time
                 unattributed; detect2d --profile-trace then trace-dump --ops
                 as processes (kernel 1 under yolov5_crop). Lines telemetry
                 (per model: busy share, MFU, p50 with and without the
                 ledger, the measured cost and its roofline row, the op
                 attribution) and telemetry_cli
 36. telemetry_plane — serve on copies of examples/yolov5_crop and
                 pointpillar_kitti in a process of its own, without and with
                 --metrics-port auto --slo-ms 33 --op-sample-interval 2
                 --history-interval 1; utils/loadgen.run_pool with 4 clients
                 for 1.5 s an entry (a seeded 480x640 frame, 20,000- and
                 120,000-point scans). Held: every METRIC_TYPES family on
                 /metrics, each model's e2e histogram count equal to the
                 requests it answered, SLO met + missed equal to them, the
                 busy share in (0, 1], a /profile?seconds=1 capture under
                 load with kernel 1 under yolov5_crop and kernels 3 and 4
                 under pointpillar_kitti, /history holding both models, no
                 server thread alive after stop. Line telemetry_plane:
                 frames/s, p50, p99 with and without telemetry, attainment
                 at 33 ms, the sampler's duty cycle and captures
 37. lifecycle — the model lifecycle and tenant plane (runtime/lifecycle.py):
                 serve's wiring in this process over copies of
                 examples/yolov5_crop, yolov5l_crop (conf 0.05),
                 pointpillar_kitti and second_iou with a tenants.yaml
                 (yolov5_crop pinned in a tenant with a quota; the others in
                 a tenant with max_inflight), a seeded schedule of 24
                 requests (6 a model, interleaved) through a loopback
                 client: unbudgeted first (the reference answers, each
                 model's measured cost: param_bytes + graph-pool bytes),
                 then under an --hbm-budget where the two largest costs fit
                 and the three largest do not. Held: answers bitwise equal;
                 promotions >= 5, evictions >= 3; the pinned model never
                 evicted; resident bytes within the budget; a cold model's
                 live pool bytes 0; /snapshot and /metrics lifecycle lines;
                 two promotions while a second client keeps the pinned model
                 busy, every answer of both bitwise;
                 kernels 1, 3, 4 and 5 bitwise against their plain versions
                 on the phase's inputs, their launches split into capture
                 warmups and replays. Lines lifecycle_costs and lifecycle:
                 recapture and promotion ms, cold and warm request p50, the
                 card's memory around an eviction with and without
                 empty_cache
 38. sessions  — streaming sessions (runtime/sessions.py) and the tracker
                 (ops/tracking.py): the captured step, group step (4
                 cameras) and coast on the card against the plain tracker
                 over a seeded 40-frame drive of 128 CenterPoint-shaped rows
                 with a tie and a NaN centre (ids and associations bitwise,
                 floats within 1e-5), greedy_assign on a tied and a NaN
                 matrix, advance/release under
                 torch.cuda.set_sync_debug_mode("error"); serve
                 --max-sessions 16 in this process over
                 examples/centerpoint_nusc (seeded det3d weights) and
                 yolov5_crop: run_streams replays 4 x 12 clouds at the
                 262,144 bucket and 2 x 6 frames, every response carrying
                 the track outputs, which the plain tracker re-run on the
                 CPU over the responses' detections gives bitwise; one
                 kernel-4 launch a CenterPoint frame and one kernel-1 launch
                 a yolov5_crop frame; the echo drive (8 streams x 30 frames
                 at 10 fps, TrackerConfig(max_tracks=32)): goodput 1.0, no
                 alias, no ID switch, the plain tracker's re-run over its
                 responses bitwise. Line sessions: the largest float
                 difference, the step's device and host us a frame at G = 1
                 and 4, a CenterPoint request's p50 with and without a
                 sequence_id, the replays' p50 and frames/s, each echo
                 stream's sustained frames/s and the worst inter-frame p99
 39. router    — the front-door router (runtime/router.py) over two serve
                 processes (--replica-of smoke/fleet, --warmup, session id
                 namespaces 1 and 2) of phase 38's repository: `route`
                 prints both IN-ROTATION with the label; 24 yolov5_crop
                 requests with hedging forced, each bitwise the answer
                 replica 0 gives directly, at least one hedge, kernel 1
                 launched once an attempt that ran (the replicas report
                 their counts on SIGUSR1); run_streams over the list, 2
                 CenterPoint streams x 8 clouds pinned to their rendezvous
                 owners (8 kernel-4 launches on each replica, ids equal to
                 a drive against one replica); run_open_loop over the list
                 at half 4 unary clients' frames/s for 3 s with replica 1
                 SIGKILLed 1 s in: nothing lost, 90% complete, a failover,
                 `route` 1/2 in rotation, then one frame of a stream of the
                 dead replica re-homed (one handoff, the session restarted
                 on replica 0). Line router: routed against direct p50 and
                 p99, the time from the kill to the first routed success,
                 hedges, each router's stats()

then the ``{"kernels": [...]}`` record and, last, the ``{"ok": true, ...}``
line. Any failed check exits nonzero; nothing is caught or falls back.
It imports nothing of JAX. Without a CUDA device, or run from a directory
that holds this script and not the package, it exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parent
B_MAIN, K_MAIN, MAX_DET, NC = 8, 1024, 300, 2
PROFILE_REQUESTS, PROFILE_TOP = 10, 12
# the 3D path: PointPillars' pre_max candidates, max_det rows of 9 columns;
# the anchors of its KITTI head (216 x 248 cells x 6), which kernel 3's
# gathered form reads through the top-k indices
K_3D, MAX_DET_3D, COLS_3D = 256, 128, 9
N_ANCHORS_3D = 321408
SCAN_POINTS = (20000, 120000)  # the source's default; a full HDL-64 scan
SERVE_REQUESTS_3D = 30
# the largest K kernels 1, 2 and 4 take: their order pass's sort of 16,384
# (score, index) keys fills a block's shared memory
K_LARGEST = 16384
# the boxes of a YOLO head at 512 x 512 before any top-k: 3 anchors on
# 64^2 + 32^2 + 16^2 cells (the reference's 16,128-box heads)
K_YOLO_HEAD = 16128
# float operations of kernel 3 per candidate: diag 4, centres 6, sizes
# 3 x (2 clamp, exp, mul), heading 9
DECODE_OPS = 31
# fp32 non-tensor-core rate and memory rate of an H100 SXM at 700 W
# (NVIDIA H100 data sheet)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# float operations of one IoU test against the chosen box in the
# greedy loop: 2 min, 2 max, 2 sub, 2 clamp, 1 mul, 1 add, 1 sub,
# 1 max, 1 div, 1 compare
IOU_OPS = 14
# SECOND's voxel stage: the KITTI cap of occupied cells; the scan size at
# which the card is compared with the CPU below the cap
SECOND_SLOTS = 40000
# the ragged path: 8 clouds a pack, each 20k (the synthetic source's
# default) to 120k points (a full HDL-64 scan); bursts timed in phase 20
RAGGED_CLOUDS, RAGGED_POINTS, RAGGED_ROUNDS = 8, (20000, 120000), 20
# the 2D main path's camera frames
FRAME_HW = (480, 640)
# phases 22-24: replays a launch count is read over; requests a timed path;
# the driver's frames and clouds
GRAPH_REPLAYS, GRAPH_REQUESTS_2D, GRAPH_REQUESTS_3D = 5, 30, 20
DRIVER_FRAMES, DRIVER_CLOUDS = 64, 16
# the CUDA runtime calls by which the host issues device work: each is
# one host-issued device op of a request (phase 23)
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
               "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
# what the main paths serve, for phases 22-24: model -> pipelines, inputs,
# repository and channel
SERVED: dict = {}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(phase: str, card: str, **fields) -> None:
    print(json.dumps({"phase": phase, "card": card, **fields}), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean ms of ``fn`` on the card's clock: CUDA events around ``reps``
    back-to-back calls after ``warmup`` calls."""
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


def kernel_device_ms(fn, counter, reps: int = 50) -> float:
    """Mean device time of one launch by ``fn``, which must launch its
    kernel and nothing else (inputs already of the kernel's types): CUDA
    events around ``reps`` back-to-back calls queued behind a sleep
    kernel, so the card runs them without waiting on the host in between
    (its wrapper's host time, tens of microseconds, would otherwise be
    measured for a kernel of microseconds). Fails unless all ``reps``
    launches were queued before the card reached the first event."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24  # about 9 ms at 1.98 GHz
    for _ in range(4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        before = counter.count
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        check(counter.count - before == reps, f"{reps} calls launched {counter.count - before} times")
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 4
    fail(f"the card reached the first event before {reps} launches were queued")


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bit patterns, so that a comparison sees -0.0."""
    return t.contiguous().view(torch.int32)


def roofline(nbytes: int, ops: int) -> tuple[float, str]:
    """The least ms the card could take: the larger of ``nbytes`` over the
    memory rate and ``ops`` over the fp32 rate, and which of the two."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def serve(call, inputs, reps: int, unit: str = "scans_per_s", size=lambda x: 1) -> dict:
    """``reps`` closed-loop calls of ``call``, one caller, cycling over
    ``inputs``: ``unit`` (the inputs' ``size`` summed, over the wall) and
    p50 latency, on the host's clock."""
    lat = []
    t0 = time.perf_counter()
    for r in range(reps):
        t = time.perf_counter()
        call(inputs[r % len(inputs)])
        lat.append(time.perf_counter() - t)
    wall = time.perf_counter() - t0
    n = sum(size(inputs[r % len(inputs)]) for r in range(reps))
    return {unit: n / wall, "p50_ms": float(np.median(lat)) * 1e3, "requests": reps}


def uniform_clouds(seed: int, pc_range, points: int, count: int = 2) -> list[np.ndarray]:
    """``count`` (points, 4) float32 clouds drawn uniformly over ``pc_range``."""
    rng = np.random.default_rng(seed)
    r = pc_range
    return [
        np.column_stack([rng.uniform(r[0], r[3], points), rng.uniform(r[1], r[4], points),
                         rng.uniform(r[2], r[5], points), rng.uniform(0, 1, points)]
                        ).astype(np.float32)
        for _ in range(count)
    ]


def card_vs_cpu(card_pipe, cpu_pipe, clouds) -> tuple[float, int]:
    """The same clouds through a 3D pipeline on the card and its twin on
    the CPU (same seed, same weights): equal kept counts and labels, rows
    within 1e-5, the bar at which the CPU tests hold the port to the JAX
    package. Returns the largest row difference and the rows kept."""
    err_max, kept = 0.0, 0
    for pc in clouds:
        g, c = card_pipe.infer(pc), cpu_pipe.infer(pc)
        check(len(g["pred_scores"]) == len(c["pred_scores"]) > 0, "card and CPU keep other counts")
        check(np.array_equal(g["pred_labels"], c["pred_labels"]), "card and CPU labels differ")
        err = max(float(np.abs(g[k] - c[k]).max()) for k in ("pred_boxes", "pred_scores"))
        check(err <= 1e-5, f"card and CPU rows differ by {err}")
        err_max, kept = max(err_max, err), kept + len(g["pred_scores"])
    return err_max, kept


def nan_cells_card_vs_cpu(dev: torch.device) -> dict:
    """Cell assignment of NaN, +-inf, +-1e10 and +-2^31 coordinates on the
    card against the CPU, at the KITTI PointPillars grid: equal cells and
    valid rows, the NaN x row in cell x = 0 and kept (XLA's cast rule,
    ``ops/voxelize.xla_f32_to_i32``). Returns what was compared."""
    from triton_client_tpu_torch.ops import kernel_cases
    from triton_client_tpu_torch.ops.voxelize import VoxelConfig, assign_cells, xla_f32_to_i32

    pts = kernel_cases.special_cloud(200, VoxelConfig().point_cloud_range, seed=3)
    x = torch.from_numpy(np.concatenate([kernel_cases.SPECIAL_COORDS, pts[:, :3].ravel()]))
    check(torch.equal(xla_f32_to_i32(x.to(dev)).cpu(), xla_f32_to_i32(x)),
          "the card's float -> int32 cast differs from the CPU's")
    p, n = torch.from_numpy(pts), torch.tensor(190)
    ijk, valid = assign_cells(p.to(dev), n.to(dev), VoxelConfig())
    want_ijk, want_valid = assign_cells(p, n, VoxelConfig())
    check(torch.equal(ijk.cpu(), want_ijk) and torch.equal(valid.cpu(), want_valid),
          "the card's cells of special coordinates differ from the CPU's")
    check(int(want_ijk[0, 0]) == 0 and bool(want_valid[0]), "a NaN x did not land in cell 0")
    # whether PyTorch's own CUDA cast already follows the rule (reported)
    plain_cast = torch.equal(x.to(dev).to(torch.int32).cpu(), xla_f32_to_i32(x))
    return {"values": int(x.numel()), "points": int(pts.shape[0]), "equal": True,
            "torch_cast_on_card_follows_xla": plain_cast}


def device_profile(run, requests: int) -> dict:
    """Where a request's time goes: ``run`` called ``requests`` times under
    torch.profiler (the wall includes the profiler's cost). Device ms and
    busy share per request, device ops per request, the device ops that
    took the most time."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(requests):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_ops = [e for e in prof.events() if e.device_type.name == "CUDA"]
    check(len(device_ops) > 0, "torch.profiler saw no device op")
    device_s = sum(e.device_time_total for e in device_ops) / 1e6
    by_name: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA":  # names cut to 80 characters can collide: sum them
            key = e.key[:80]
            by_name[key] = by_name.get(key, 0.0) + e.self_device_time_total / requests / 1e3
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:PROFILE_TOP]
    return dict(requests=requests, wall_ms_per_request=wall / requests * 1e3,
                device_ms_per_request=device_s / requests * 1e3,
                device_busy_share=device_s / wall, device_idle_share=1.0 - device_s / wall,
                device_ops_per_request=len(device_ops) / requests,
                top_device_ops_ms_per_request=dict(top))


def pass_split(fn, kernel: str, passes=("order", "mask", "scan"), reps: int = 20,
               sessions: int = 3) -> dict:
    """Each pass (launch) of a kernel, named ``<kernel>_<pass>``: its mean
    device µs over the records torch.profiler kept of ``reps`` calls of
    ``fn``, and how many it kept (it has dropped records of µs-long
    kernels, and once every record of a session). Fails unless one of
    ``sessions`` profiler sessions saw every pass by its name; returns that
    session's numbers and how many sessions it took."""
    fn()
    torch.cuda.synchronize()
    for session in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, seen = {}, {}
        for e in prof.key_averages():
            for name in passes:
                if e.device_type.name == "CUDA" and f"{kernel}_{name}" in e.key:
                    us[name] = e.self_device_time_total / e.count
                    seen[name] = e.count
        if set(us) == set(passes):
            return {"us": us, "records_seen": seen, "calls": reps, "sessions": session}
    fail(f"{kernel}: in {sessions} profiler sessions the last saw passes {sorted(us)}")


def with_workspace(run):
    """``run()``, which makes one call of a mask-scan kernel's wrapper
    (kernels 1 and 4), then the workspace buffer that call allocated and
    its arrays' sizes, for reading back what the kernel wrote there."""
    from triton_client_tpu_torch.ops import mask_scan

    seen, allocate = [], mask_scan.workspace

    def record(device, sizes):
        ws, ptrs = allocate(device, sizes)
        seen.append((ws, sizes))
        return ws, ptrs

    mask_scan.workspace = record
    try:
        out = run()
    finally:
        mask_scan.workspace = allocate
    torch.cuda.synchronize()
    check(len(seen) == 1, f"one kernel call allocated {len(seen)} workspaces")
    return out, *seen[0]


def count_order_paths(ws, sizes, live, paths: dict, label: str) -> None:
    """Reads back which order the order pass took for each image (its own,
    or a sort), holds it to what the live scores call for (their own when
    already in visiting order or with a live NaN) and adds the images to
    ``paths``."""
    from triton_client_tpu_torch.ops import mask_scan

    took = mask_scan.took_own_order(ws, sizes).cpu()
    want = (mask_scan.in_visiting_order(live) | torch.isnan(live).any(1)).cpu()
    check(torch.equal(took, want),
          f"{label}: the order pass took its own order {took.tolist()}, not {want.tolist()}")
    paths["input_order"] += int(took.sum())
    paths["sorted"] += int((~took).sum())


def live_counts(boxes, live, thresh, max_det):
    """Live candidates at each step of the greedy loop, summed over the
    batch: the IoU tests this run's data needs (the kernel skips the
    dead ones and stops when none is left)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    lane = torch.arange(live.shape[1], device=live.device)
    total = 0
    for _ in range(max_det):
        alive = live > float("-inf")
        n = int(alive.sum())
        if n == 0:
            break
        total += n
        best = live.argmax(1)[:, None]
        g = lambda t: t.gather(1, best)  # noqa: E731
        iw = (torch.minimum(x2, g(x2)) - torch.maximum(x1, g(x1))).clamp(min=0)
        ih = (torch.minimum(y2, g(y2)) - torch.maximum(y1, g(y1))).clamp(min=0)
        inter = iw * ih
        iou = inter / (area + g(area) - inter).clamp(min=1e-9)
        live = torch.where((iou > thresh) | (lane == best), float("-inf"), live)
    return total


def live_counts_3d(iou, live, thresh, max_det):
    """Kernel 4's loop on the card in plain PyTorch, counting what this
    run's data needs: the live candidates tested at each step (summed
    over the batch) and the steps that kept a candidate (each reads one
    IoU row)."""
    lane = torch.arange(live.shape[1], device=live.device)
    image = torch.arange(live.shape[0], device=live.device)
    tests = kept = 0
    for _ in range(max_det):
        alive = live > float("-inf")
        n = int(alive.sum())
        if n == 0:
            break
        tests += n
        kept += int(alive.any(1).sum())
        best = live.argmax(1)
        suppress = (iou[image, best] > thresh) | (lane == best[:, None])
        live = torch.where(suppress, float("-inf"), live)
    return tests, kept


def candidate_stage(model, heads, top_idx, reps: int = 200) -> dict:
    """The fused 3D route from the top-k's output to the decoded boxes, as
    it runs (kernel 3 reading its rows through ``top_idx``) and as it ran
    (the gathers of ``topk_candidates``, then kernel 3 on their rows): the
    device ops of one call (torch.profiler, 20 calls), the stage's device
    ms (``kernel_device_ms``: every op of ``reps`` calls queued behind a
    sleep kernel) and its host ms a call (perf_counter over ``reps`` calls
    issued without a wait). torch.profiler may drop records of µs-long
    kernels (phase 10), so a count below the true one is possible, never
    one above it."""
    from triton_client_tpu_torch.models.pointpillars import gather_candidates
    from triton_client_tpu_torch.ops import gpu_decode3d
    from triton_client_tpu_torch.pipelines.detect3d import gathered_decode_args

    args = gathered_decode_args(model, heads, top_idx)
    sel = {"top_idx": top_idx, "scores": None, "labels": None}

    def gathers_then_kernel():
        cand = gather_candidates(heads, model.anchors, sel)
        return gpu_decode3d.fused_residual_decode(cand["deltas"], cand["anchors"],
                                                  cand["dir_bin"], *args[4:])

    def gathered():
        return gpu_decode3d.gather_residual_decode(*args)

    # both stages in one profiler session: every device op that is not the
    # gathered kernel belongs to the gathers-then-kernel stage
    gathered()
    gathers_then_kernel()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            gathered()
            gathers_then_kernel()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    ops = {"gathered_kernel": [n for n in names if "residual_decode_3d_kernel<true>" in n]}
    ops["gathers_then_kernel"] = [n for n in names if "residual_decode_3d_kernel<true>" not in n]
    out = {}
    for name, fn in (("gathered_kernel", gathered), ("gathers_then_kernel", gathers_then_kernel)):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) / reps * 1e3
        torch.cuda.synchronize()
        out[name] = {"device_ops_per_call": len(ops[name]) / 20,
                     "ops": sorted(set(n[:60] for n in ops[name])),
                     "device_ms": kernel_device_ms(fn, gpu_decode3d.launches, reps=50),
                     "host_ms": host_ms}
    check(torch.equal(bits(gpu_decode3d.gather_residual_decode(*args)),
                      bits(gathers_then_kernel())), "the two stages' boxes differ")
    return out


# the phases a run can name (``--phase NAME``), in the order a whole run takes
# them: name -> (the phase numbers of the module docstring, the groups whose
# served models it reuses and which run before it)
PHASES = {
    "yolov5": ("2-6", ()),
    "3d": ("7-11", ()),
    "second": ("12-16", ()),
    "ragged": ("17-20", ()),
    "dense_batched": ("21", ("yolov5",)),
    "graphs": ("22-23", ("yolov5", "3d", "second")),
    "driver": ("24", ("yolov5", "3d")),
    "facade": ("25", ()),
    "layout": ("26", ()),
    "remote": ("27", ()),
    "centerpoint": ("28", ()),
    "precision": ("29", ()),
    "replay": ("30", ()),
    "detectron_v4": ("31", ()),
    "ensemble": ("32", ()),
    "loadgen": ("33", ()),
    "second_sparse": ("34", ()),
    "telemetry": ("35", ()),
    "telemetry_plane": ("36", ()),
    "lifecycle": ("37", ("yolov5", "3d", "second")),
    "sessions": ("38", ()),
    "router": ("39", ()),
}


def parse_args(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="On-card smoke test of the PyTorch/CUDA port (module docstring).")
    p.add_argument("--phase", action="append", default=[], metavar="NAME",
                   help="run only this group of phases, and the groups it needs (repeatable; "
                   f"default: every group). Groups: {', '.join(PHASES)}")
    args = p.parse_args(argv)
    unknown = [name for name in args.phase if name not in PHASES]
    if unknown:
        p.error(f"unknown phase {unknown[0]!r} (known: {', '.join(PHASES)})")
    return args


def selected(names: list[str]) -> list[str]:
    """The named groups and the groups they need, in the run's order; every
    group when none is named."""
    if not names:
        return list(PHASES)
    want, stack = set(), list(names)
    while stack:
        name = stack.pop()
        if name not in want:
            want.add(name)
            stack.extend(PHASES[name][1])
    return [name for name in PHASES if name in want]


def main(argv: list[str] | None = None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    try:
        from triton_client_tpu_torch.ops import (
            cuda_build,
            gpu_decode,
            gpu_decode3d,
            gpu_nms,
            gpu_segment,
            gpu_suppress3d,
            gpu_voxel,
        )
    except ModuleNotFoundError as e:
        # run from a directory that holds this script and not the package
        print(f"chip_smoke: the port's package is not importable from {ROOT} ({e}); "
              "run the script from the root of a checkout; nothing run", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    # each kernel's launches, then kernel 3's in its gathered form (also
    # counted in gpu_decode3d.launches)
    counters = (gpu_decode.launches, gpu_nms.launches, gpu_decode3d.launches,
                gpu_suppress3d.launches, gpu_voxel.launches, gpu_segment.launches,
                gpu_decode3d.gathered_launches)

    # -- 1. card ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = smi
    build_s = cuda_build.build_all()
    emit("card", card, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), build_s=build_s)

    groups = selected(args.phase)
    emit("phases", card, run=groups, named=args.phase)

    record = []  # the kernels' rows, in the order 1-6, of the groups that ran
    if "yolov5" in groups:
        record += run_yolov5(card, dev, counters)
    if "3d" in groups:
        record_3d = run_3d(card, dev, counters)
        for row in record_3d:  # kernels 3-4 run on both 3D paths
            row["launches_by_path"] = {"pointpillars": row["launches"]}
        record += record_3d
    if "second" in groups:
        record_second, second_launches = run_second(card, dev, counters)
        for row in record:
            if row["name"] in second_launches:
                row["launches_by_path"]["second_iou"] = second_launches[row["name"]]
        record += record_second
    if "ragged" in groups:
        record += run_ragged(card, dev, counters)
    rows = {row["name"]: row for row in record}
    for row in record:
        row.setdefault("launches_by_path", {})
    if "dense_batched" in groups:
        served = SERVED["yolov5n"]
        run_dense_batched(card, counters, served["repo"], served["channel"], served["frames"])
    if "graphs" in groups:
        run_graphs(card, dev, counters)
    if "driver" in groups:
        run_driver(card)
    if "facade" in groups:
        run_facade(card, counters)
    if "layout" in groups:
        run_layout(card, counters)
    if "remote" in groups:
        run_remote(card, counters)
    if "centerpoint" in groups:
        record_cp = run_centerpoint(card, counters)
        # kernel 4 also runs CenterPoint's tail, at K = 128 rows of 11 columns
        if "suppress_pack_3d" in rows:
            rows["suppress_pack_3d"]["launches_by_path"]["centerpoint"] = record_cp.pop(
                "launches")
            rows["suppress_pack_3d"]["centerpoint_shape"] = record_cp
    # phase 29's paths: each precision policy on each family, counted alone;
    # phase 30's replays
    if "precision" in groups:
        for path, counts in run_precision(card, counters).items():
            for name, n in counts.items():
                if n and name in rows:
                    rows[name]["launches_by_path"][f"precision_{path}"] = n
    if "replay" in groups:
        for path, counts in run_replay(card, counters).items():
            for name, n in counts.items():
                if n and name in rows:
                    rows[name]["launches_by_path"][f"replay_{path}"] = n
    # phase 31: kernel 1 on the detectron family's scored tail and YOLOv4's
    if "detectron_v4" in groups:
        detectron_v4 = run_detectron_v4(card, counters)
        if "decode_nms_2d" in rows:
            for path, n in detectron_v4["launches"].items():
                rows["decode_nms_2d"]["launches_by_path"][f"detectron_v4_{path}"] = n
            rows["decode_nms_2d"]["scored_shape"] = detectron_v4["scored_shape"]
    # phase 32: kernel 1 inside the fused ensemble's one graph
    if "ensemble" in groups:
        ensemble_launches = run_ensemble(card, counters)
        if "decode_nms_2d" in rows:
            rows["decode_nms_2d"]["launches_by_path"]["ensemble_fused"] = ensemble_launches
    if "loadgen" in groups:
        run_loadgen(card)
    # phase 34: kernels 3 and 4 on the sparse SECOND's tail
    if "second_sparse" in groups:
        for name, n in run_second_sparse(card, counters).items():
            if name in rows:
                rows[name]["launches_by_path"]["second_sparse005"] = n
    if "telemetry" in groups:
        run_telemetry(card, counters)
    if "telemetry_plane" in groups:
        run_telemetry_plane(card)
    # phase 37: kernels 1, 3, 4 and 5 recaptured after each promotion
    if "lifecycle" in groups:
        for name, split in run_lifecycle(card, counters).items():
            if name in rows:
                rows[name]["launches_by_path"]["lifecycle_capture"] = split["capture"]
                rows[name]["launches_by_path"]["lifecycle_replay"] = split["replay"]
    # phase 38: kernel 4 once a CenterPoint session frame, kernel 1 once a
    # yolov5_crop one
    if "sessions" in groups:
        for name, n in run_sessions(card, counters).items():
            if name in rows:
                rows[name]["launches_by_path"]["sessions"] = n
    # phase 39: kernel 1 once a hedged request's attempt that ran on a
    # replica, kernel 4 once a routed CenterPoint session frame
    if "router" in groups:
        for name, n in run_router(card).items():
            if name in rows:
                rows[name]["launches_by_path"]["router"] = n
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def run_yolov5(card: str, dev: torch.device, counters) -> list[dict]:
    """Phases 2-6: kernels 1 and 2 against their plain versions, YOLOv5n
    served through ``CUDAChannel`` (``SERVED["yolov5n"]``, which phases 21-24
    reuse), its checks, times and profile. Returns kernels 1 and 2's rows."""
    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.io.sources import SyntheticImageSource
    from triton_client_tpu_torch.ops import gpu_decode, gpu_nms, kernel_cases, mask_scan
    from triton_client_tpu_torch.ops import nms as tnms
    from triton_client_tpu_torch.ops.boxes import xywh2xyxy
    from triton_client_tpu_torch.ops.detect_postprocess import extract_boxes, topk_candidates
    from triton_client_tpu_torch.ops.nms import class_offset_boxes
    from triton_client_tpu_torch.ops.preprocess import normalize_image, resize_bilinear
    from triton_client_tpu_torch.pipelines.detect2d import (
        Detect2DConfig,
        build_yolov5_pipeline,
        load_class_names,
    )
    from triton_client_tpu_torch.runtime.repository import ModelRepository

    # -- 2. kernels against their plain versions, on the card -------------------
    def to_dev(arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    # every kind as drawn (not in score order: the order pass sorts) and as
    # topk_candidates hands candidates over (in order: taken as it stands),
    # then K past one group of 32 mask words, up to the largest K taken
    decode_cases = [
        (kind, seed, fmt, agnostic, K_MAIN, MAX_DET, sort)
        for kind in kernel_cases.KINDS
        for seed, fmt, agnostic in ((0, "xywh", False), (1, "xyxy", True))
        for sort in (False, True)
    ] + [("random", 2, "xywh", True, K_MAIN, MAX_DET, False),
         ("ties", 3, "xyxy", False, K_MAIN, MAX_DET, False)] + [
        ("random", 4, "xywh", False, k, max_det, sort)
        for k, max_det in ((1025, 1025), (K_LARGEST, MAX_DET), (K_LARGEST, K_LARGEST))
        for sort in (False, True)
    ]
    check(gpu_decode.smem_fits(K_LARGEST) and not gpu_decode.smem_fits(K_LARGEST + 1),
          f"decode_nms_2d does not take K up to {K_LARGEST} exactly")
    k1_err = 0.0
    k1_order_paths = {"input_order": 0, "sorted": 0}
    for kind, seed, fmt, agnostic, k, max_det, sort in decode_cases:
        arrays = kernel_cases.batch(kind, B_MAIN, k, NC, seed, fmt)
        if sort:
            arrays = kernel_cases.score_sorted(*arrays)
        args = to_dev(arrays)
        kw = dict(iou_thresh=0.45, max_det=max_det, box_format=fmt, class_agnostic=agnostic)
        label = f"{kind}, K {k}, max_det {max_det}, {fmt}, sorted {sort}"
        (rows, keep), ws, sizes = with_workspace(
            lambda: gpu_decode.fused_decode_nms_2d(*args, **kw))
        live = torch.where(args[3], args[1], float("-inf"))
        count_order_paths(ws, sizes, live, k1_order_paths, f"decode_nms_2d ({label})")
        del ws
        want_rows, want_keep = gpu_decode.decode_nms_2d_reference(*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(keep, want_keep), f"decode_nms_2d keep differs ({label})")
        check(torch.equal(bits(rows), bits(want_rows)), f"decode_nms_2d rows differ ({label})")
        check(kind != "nan" or not keep.any(), "decode_nms_2d kept a box beside a live NaN")
        k1_err = max(k1_err, float((rows - want_rows).abs().max()))
    check(min(k1_order_paths.values()) > 0, f"an order path was not taken: {k1_order_paths}")
    # kernel 2: every kind as drawn (the order pass sorts) and in score
    # order (taken as it stands, as the unfused route's top-k hands them
    # over), then the reference's 16,128-box heads and the largest N taken
    k2_err = 0
    k2_order_paths = {"input_order": 0, "sorted": 0}
    nms_cases = [(kind, K_MAIN, MAX_DET, sort) for kind in kernel_cases.KINDS
                 for sort in (False, True)] + [
        ("random", n, max_det, sort)
        for n, max_det in ((K_YOLO_HEAD, MAX_DET), (K_LARGEST, MAX_DET), (K_LARGEST, K_LARGEST))
        for sort in (False, True)
    ]
    check(gpu_nms.smem_fits(K_YOLO_HEAD) and gpu_nms.smem_fits(K_LARGEST)
          and not gpu_nms.smem_fits(K_LARGEST + 1),
          f"greedy_nms does not take N up to {K_LARGEST} exactly")
    for i, (kind, n, max_det, sort) in enumerate(nms_cases):
        boxes, scores = kernel_cases.nms_batch(kind, B_MAIN if n == K_MAIN else 2, n, 40 + 8 * i,
                                               sort)
        boxes, scores = to_dev([boxes, scores])
        label = f"{kind}, N {n}, max_det {max_det}, sorted {sort}"
        (idx, valid), ws, sizes = with_workspace(
            lambda: gpu_nms.nms_greedy(boxes, scores, 0.45, max_det))
        count_order_paths(ws, sizes, scores, k2_order_paths, f"greedy_nms ({label})")
        del ws
        want_idx, want_valid = gpu_nms.nms_greedy_reference(boxes, scores, 0.45, max_det)
        torch.cuda.synchronize()
        check(torch.equal(valid, want_valid), f"greedy_nms valid differs ({label})")
        check(torch.equal(idx, want_idx), f"greedy_nms indices differ ({label})")
        if kind == "nan":  # every slot invalid, at the first NaN's index
            first_nan = torch.isnan(scores).to(torch.int8).argmax(1, keepdim=True).to(torch.int32)
            check(not valid.any() and torch.equal(idx, first_nan.expand_as(idx)),
                  "greedy_nms: a live NaN did not empty every slot at its index")
        k2_err = max(k2_err, int((idx - want_idx).abs().max()))
    check(min(k2_order_paths.values()) > 0, f"an order path was not taken: {k2_order_paths}")
    # the pallas route past a block's shared memory raises, launching nothing
    n_big = K_LARGEST + 1
    check(not gpu_nms.smem_fits(n_big), f"{n_big} candidates fit shared memory")
    os.environ["TRITON_CLIENT_TPU_NMS"] = "pallas"
    before = gpu_nms.launches.count
    try:
        tnms.nms(torch.zeros((1, n_big, 4), device=dev), torch.zeros((1, n_big), device=dev))
        raised = False
    except ValueError:
        raised = True
    del os.environ["TRITON_CLIENT_TPU_NMS"]
    check(raised and gpu_nms.launches.count == before,
          "TRITON_CLIENT_TPU_NMS=pallas past shared memory did not raise on the card")
    emit("kernels_vs_plain", card, kernels=[
        {"name": "decode_nms_2d", "cases": len(decode_cases), "shape": [B_MAIN, K_MAIN, MAX_DET],
         "largest_k": K_LARGEST, "images_by_order_path": k1_order_paths,
         "match": True, "max_abs_err": k1_err},
        {"name": "greedy_nms", "cases": len(nms_cases), "shape": [B_MAIN, K_MAIN, MAX_DET],
         "largest_k": K_LARGEST, "yolo_head_k": K_YOLO_HEAD,
         "images_by_order_path": k2_order_paths, "match": True, "max_abs_err": k2_err},
    ])

    # -- 3. the main path --------------------------------------------------------
    names = load_class_names(str(ROOT / "data" / "crop.names"))
    check(len(names) == NC, f"data/crop.names holds {len(names)} classes")
    base = Detect2DConfig(
        model_name="yolov5n", input_hw=(512, 512), num_classes=NC, conf_thresh=0.3,
        iou_thresh=0.45, max_det=MAX_DET, max_nms=K_MAIN, class_names=names,
    )
    variants = {
        "yolov5n": base,
        "yolov5n_c005": dataclasses.replace(base, model_name="yolov5n_c005", conf_thresh=0.05),
        "yolov5n_unfused": dataclasses.replace(base, model_name="yolov5n_unfused", fused="off"),
        "yolov5n_c005_unfused": dataclasses.replace(
            base, model_name="yolov5n_c005_unfused", conf_thresh=0.05, fused="off"
        ),
    }
    repo = ModelRepository()
    pipes = {}
    for name, cfg in variants.items():
        # one seed: every variant holds the same weights
        pipe, spec, model = build_yolov5_pipeline(
            variant="n", num_classes=NC, input_hw=(512, 512), config=cfg, device="cuda", seed=0
        )
        # each batch size this run sends the variant: 1 and 8, and every
        # size the batcher may merge for yolov5n_c005 (phase 21)
        sizes = range(1, B_MAIN + 1) if name == "yolov5n_c005" else (1, B_MAIN)
        repo.register(spec, pipe.infer_fn(),
                      warmup=functools.partial(pipe.warmup, FRAME_HW, batch_sizes=sizes))
        pipes[name] = (pipe, spec, model)
    check(pipes["yolov5n"][1].extra["fused_stages"] == ["decode_nms"], "auto did not fuse on CUDA")
    check(pipes["yolov5n_unfused"][1].extra["fused_stages"] == [], "off still fused")
    channel = CUDAChannel(repo)
    channel.register_channel()
    # every graph before traffic (the registration warmup); the unfused
    # routes also under TRITON_CLIENT_TPU_NMS=pallas, which phases 3, 5
    # and 22 serve
    for name in variants:
        repo.get(name).warmup()
    os.environ["TRITON_CLIENT_TPU_NMS"] = "pallas"
    for name in ("yolov5n_unfused", "yolov5n_c005_unfused"):
        repo.get(name).warmup()
    del os.environ["TRITON_CLIENT_TPU_NMS"]

    frames = np.stack([f.data for f in SyntheticImageSource(40, FRAME_HW, seed=0)])
    SERVED["yolov5n"] = {"pipes": pipes, "repo": repo, "channel": channel, "frames": frames}
    b1 = [frames[i:i + 1] for i in range(4)]
    b8 = [frames[8 + 8 * i: 16 + 8 * i] for i in range(4)]

    def ask(model_name, batch):
        return channel.do_inference(InferRequest(model_name, {"images": batch})).outputs

    for name in variants:  # warm-up (cuDNN picks its algorithms), not counted
        ask(name, b1[0])
        ask(name, b8[0])
    os.environ["TRITON_CLIENT_TPU_NMS"] = "pallas"  # the unfused route's kernel
    for counter in counters:
        counter.reset()
    out = {}
    for i, batch in enumerate(b1 + b8):
        out[("yolov5n", i)] = ask("yolov5n", batch)
    out["c005"] = ask("yolov5n_c005", b8[0])
    out["unfused"] = ask("yolov5n_unfused", b8[0])
    out["c005_unfused"] = ask("yolov5n_c005_unfused", b8[0])
    launches = {"decode_nms_2d": gpu_decode.launches.count, "greedy_nms": gpu_nms.launches.count}
    del os.environ["TRITON_CLIENT_TPU_NMS"]

    for i, batch in enumerate(b1 + b8):
        o = out[("yolov5n", i)]
        n = batch.shape[0]
        check(o["detections"].shape == (n, MAX_DET, 6), f"detections {o['detections'].shape}")
        check(o["valid"].shape == (n, MAX_DET) and o["valid"].dtype == np.bool_, "valid")
        check(bool(np.isfinite(o["detections"]).all()), "non-finite detections")
    check(launches["decode_nms_2d"] == len(b1) + len(b8) + 1,
          f"decode_nms_2d launched {launches['decode_nms_2d']} times for {len(b1) + len(b8) + 1} fused requests")
    check(launches["greedy_nms"] == 2, f"greedy_nms launched {launches['greedy_nms']} times, want 2")
    n_c005 = int(out["c005"]["valid"].sum())
    check(n_c005 > 100, f"conf 0.05 kept only {n_c005} boxes")
    for fused, unfused in (("c005", "c005_unfused"), (("yolov5n", 4), "unfused")):
        check(np.array_equal(out[fused]["valid"], out[unfused]["valid"]), f"{unfused}: valid differs")
        check(np.array_equal(out[fused]["detections"], out[unfused]["detections"]),
              f"{unfused}: rows differ from the fused route")
    emit("main_path", card, model="yolov5n", input_hw=[512, 512], frame_hw=[480, 640],
         requests={"batch1": len(b1), "batch8": len(b8), "batch8_conf0.05": 1,
                   "unfused_batch8": 2},
         detections={"conf0.3": int(sum(out[("yolov5n", i)]["valid"].sum() for i in range(8))),
                     "conf0.05_batch8": n_c005},
         fused_equals_unfused=True, launches=launches)

    # -- 4. checks against the plain tail and the CPU path ------------------------
    _, _, model = pipes["yolov5n_c005"]
    with torch.no_grad():
        x = torch.from_numpy(b8[0]).to(dev).float()
        pred = model.decode(model(normalize_image(resize_bilinear(x, (512, 512)))))
    cls_conf = pred[..., 5:] * pred[..., 4:5]
    cands = topk_candidates(pred[..., :4], cls_conf.amax(-1), cls_conf.argmax(-1), 0.05, K_MAIN)
    n_valid = int(cands[3].sum())
    check(n_valid == B_MAIN * K_MAIN, f"conf 0.05 fills {n_valid} of {B_MAIN * K_MAIN} slots")
    # topk_candidates hands them over in score order: the order pass takes it as it stands
    kw1 = dict(iou_thresh=0.45, max_det=MAX_DET, box_format="xywh")
    (rows, keep), ws, sizes = with_workspace(lambda: gpu_decode.fused_decode_nms_2d(*cands, **kw1))
    check(bool(mask_scan.took_own_order(ws, sizes).all()),
          "the order pass sorted the main path's candidates")
    k1_workspace_bytes = ws.numel()
    del ws
    want_rows, want_keep = gpu_decode.decode_nms_2d_reference(*cands, **kw1)
    check(torch.equal(rows, want_rows) and torch.equal(keep, want_keep),
          "kernel differs from the plain tail on the main path's predictions")
    cpu_rows, cpu_keep = extract_boxes(pred.cpu(), 0.05, 0.45, MAX_DET, K_MAIN, fused=True)
    check(torch.equal(rows.cpu(), cpu_rows) and torch.equal(keep.cpu(), cpu_keep),
          "kernel differs from the plain tail on the CPU")
    # small input, card against the CPU path (same seed, same weights):
    # equal detection count, top rows within the golden-test bar 1e-2
    small = Detect2DConfig(num_classes=NC, input_hw=(128, 128), conf_thresh=0.05, max_det=100)
    gpu_pipe, _, _ = build_yolov5_pipeline(num_classes=NC, input_hw=(128, 128), config=small,
                                           device="cuda", seed=0)
    cpu_pipe, _, _ = build_yolov5_pipeline(num_classes=NC, input_hw=(128, 128), config=small,
                                           device="cpu", seed=0)
    sframes = np.random.default_rng(4).integers(0, 255, (2, 96, 128, 3), dtype=np.uint8)
    g_dets, g_valid = gpu_pipe.infer(sframes)
    c_dets, c_valid = cpu_pipe.infer(sframes)
    check(np.array_equal(g_valid.sum(1), c_valid.sum(1)), "card and CPU keep different counts")
    top_err = float(np.abs(g_dets[:, :5] - c_dets[:, :5]).max())
    check(np.allclose(g_dets[:, :5], c_dets[:, :5], rtol=1e-2, atol=1e-2),
          f"card and CPU top rows differ by {top_err}")
    emit("check", card, kernel_equals_plain_on_main_path=True, candidates=n_valid,
         kept=int(keep.sum()), cpu_vs_card_detections=int(g_valid.sum()),
         cpu_vs_card_top5_max_abs_err=top_err)

    # -- 5. times on the card's clock ---------------------------------------------
    offset = class_offset_boxes(xywh2xyxy(cands[0]), cands[2])
    masked = torch.where(cands[3], cands[1], float("-inf"))
    k1_call_ms = cuda_ms(lambda: gpu_decode.fused_decode_nms_2d(*cands, **kw1), reps=200)
    k1_args = (cands[0].float(), cands[1].float(), cands[2].float(), cands[3].bool())
    k1_ms = kernel_device_ms(lambda: gpu_decode.fused_decode_nms_2d(*k1_args, **kw1),
                             gpu_decode.launches)
    k1_plain_ms = cuda_ms(lambda: gpu_decode.decode_nms_2d_reference(*cands, **kw1), reps=5, warmup=1)
    k2_call_ms = cuda_ms(lambda: gpu_nms.nms_greedy(offset, masked, 0.45, MAX_DET), reps=200)
    k2_ms = kernel_device_ms(lambda: gpu_nms.nms_greedy(offset, masked, 0.45, MAX_DET),
                             gpu_nms.launches)
    k2_plain_ms = cuda_ms(lambda: gpu_nms.nms_greedy_reference(offset, masked, 0.45, MAX_DET),
                          reps=5, warmup=1)
    iou_tests = live_counts(offset, masked, torch.tensor(0.45, device=dev), MAX_DET)
    k1_bytes = B_MAIN * K_MAIN * (16 + 4 + 4 + 1) + B_MAIN * MAX_DET * (24 + 1)
    k2_bytes = B_MAIN * K_MAIN * (16 + 4) + B_MAIN * MAX_DET * (4 + 1)
    ops = iou_tests * IOU_OPS
    k1_bound, k1_by = roofline(k1_bytes, ops)
    k2_bound, k2_by = roofline(k2_bytes, ops)

    def serve2d(batches, reps):
        return serve(lambda b: ask("yolov5n", b), batches, reps, "frames_per_s",
                     lambda b: b.shape[0])

    e2e = {"batch1": serve2d(b1, 40), "batch8": serve2d(b8, 20)}
    # the unfused conf-0.05 route at batch 8 (300 kept an image), through
    # the sequential loop as deployed by default and through kernel 2
    # under the override; recorded, not claimed (host-bound)
    e2e["c005_unfused_batch8"] = serve(lambda b: ask("yolov5n_c005_unfused", b), b8, 20,
                                       "frames_per_s", lambda b: b.shape[0])
    os.environ["TRITON_CLIENT_TPU_NMS"] = "pallas"
    before = gpu_nms.launches.count
    e2e["c005_unfused_batch8_pallas"] = serve(lambda b: ask("yolov5n_c005_unfused", b), b8, 20,
                                              "frames_per_s", lambda b: b.shape[0])
    del os.environ["TRITON_CLIENT_TPU_NMS"]
    check(gpu_nms.launches.count - before == 20, "the override's requests did not launch kernel 2")
    k1_passes = pass_split(lambda: gpu_decode.fused_decode_nms_2d(*k1_args, **kw1),
                           "decode_nms_2d")
    emit("passes", card, kernel="decode_nms_2d", shape=[B_MAIN, K_MAIN, MAX_DET],
         kept=int(keep.sum()), workspace_bytes=k1_workspace_bytes, **k1_passes)
    (k2_idx, k2_valid), ws, sizes = with_workspace(
        lambda: gpu_nms.nms_greedy(offset, masked, 0.45, MAX_DET))
    check(bool(mask_scan.took_own_order(ws, sizes).all()),
          "the order pass sorted the main path's candidates (kernel 2)")
    k2_workspace_bytes = ws.numel()
    del ws
    want_idx, want_valid = gpu_nms.nms_greedy_reference(offset, masked, 0.45, MAX_DET)
    check(torch.equal(k2_idx, want_idx) and torch.equal(k2_valid, want_valid),
          "greedy_nms differs on the main path's candidates")
    k2_passes = pass_split(lambda: gpu_nms.nms_greedy(offset, masked, 0.45, MAX_DET),
                           "greedy_nms")
    emit("passes", card, kernel="greedy_nms", shape=[B_MAIN, K_MAIN, MAX_DET],
         kept=int(k2_valid.sum()), workspace_bytes=k2_workspace_bytes, **k2_passes)
    emit("times", card, kernel_ms={"decode_nms_2d": k1_ms, "greedy_nms": k2_ms},
         call_ms={"decode_nms_2d": k1_call_ms, "greedy_nms": k2_call_ms},
         plain_ms={"decode_nms_2d": k1_plain_ms, "greedy_nms": k2_plain_ms},
         bound_ms={"decode_nms_2d": k1_bound, "greedy_nms": k2_bound},
         iou_tests=iou_tests, in_process=e2e)

    # -- 6. where a request's time goes (the wall includes the profiler's cost) ---
    for batch in (b1[0], b8[0]):
        emit("profile", card, batch=batch.shape[0],
             **device_profile(lambda: ask("yolov5n", batch), PROFILE_REQUESTS))
    return [
        {"name": "decode_nms_2d", "route": "cuda",
         "source": "triton_client_tpu_torch/csrc/decode_nms_2d.cu",
         "replaces": "triton_client_tpu/ops/pallas_decode.py:155",
         "launches": launches["decode_nms_2d"], "max_abs_err": k1_err, "match": True,
         "ms": k1_ms, "call_ms": k1_call_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "passes_us": k1_passes["us"],
         "workspace_bytes": k1_workspace_bytes,
         "library_ms": None, "card": card},
        {"name": "greedy_nms", "route": "cuda",
         "source": "triton_client_tpu_torch/csrc/greedy_nms.cu",
         "replaces": "triton_client_tpu/ops/pallas_nms.py:111",
         "launches": launches["greedy_nms"], "max_abs_err": k2_err, "match": True,
         "ms": k2_ms, "call_ms": k2_call_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "passes_us": k2_passes["us"],
         "workspace_bytes": k2_workspace_bytes,
         "library_ms": None, "card": card},
    ]


def run_3d(card: str, dev: torch.device, counters) -> list[dict]:
    """Phases 7-11: the PointPillars path. ``counters`` are every kernel's
    launch counters, all set to 0 just before the main path. Returns the
    3D kernels' rows of the ``{"kernels": [...]}`` record."""
    import dataclasses as dc

    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.drivers.driver import channel_infer3d
    from triton_client_tpu_torch.io.sources import SyntheticPointCloudSource
    from triton_client_tpu_torch.models.pointpillars import PointPillarsConfig
    from triton_client_tpu_torch.ops import gpu_decode3d, gpu_suppress3d, kernel_cases, mask_scan
    from triton_client_tpu_torch.ops.voxelize import VoxelConfig
    from triton_client_tpu_torch.pipelines.detect3d import (
        Detect3DConfig,
        build_pointpillars_pipeline,
        gathered_decode_args,
        prepare_points,
    )
    from triton_client_tpu_torch.runtime.repository import ModelRepository

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a))[None].to(dev) for a in arrays]

    def decode_match(got, want, label):
        """Bitwise in every column, -0.0 included: the kernel's expf,
        sqrtf and division are the libdevice functions PyTorch's CUDA ops
        call, and --fmad=false rounds each product and sum as they do."""
        check(torch.equal(bits(got), bits(want)), f"residual_decode_3d differs ({label})")

    # -- 7. the 3D kernels against their plain versions, on the card ------------
    for i, kind in enumerate(kernel_cases.DECODE3D_KINDS):
        args = on_card(*kernel_cases.decode3d_inputs(kind, K_3D, seed=50 + i))
        got = gpu_decode3d.fused_residual_decode(*args)
        want = gpu_decode3d.residual_decode_reference(*args)
        torch.cuda.synchronize()
        decode_match(got, want, kind)
        # the gathered form at the KITTI PointPillars head: K_3D of its
        # anchors, direction logits as drawn, tied and with NaNs
        for j, dir_kind in enumerate(kernel_cases.DIR_KINDS):
            gargs = [torch.from_numpy(a).to(dev) for a in kernel_cases.gather_decode3d_inputs(
                kind, 1, N_ANCHORS_3D, K_3D, dir_kind, seed=55 + 3 * i + j)]
            got = gpu_decode3d.gather_residual_decode(*gargs)
            want = gpu_decode3d.gather_residual_decode_reference(*gargs)
            torch.cuda.synchronize()
            decode_match(got, want, f"{kind}, gathered, direction logits {dir_kind}")
    k4_cases = 0
    k4_order_paths = {"input_order": 0, "sorted": 0}

    def k4_call(run, srows, label):
        """``run()``, one kernel-4 call over ``srows``, with its order
        path read back and counted."""
        out, ws, sizes = with_workspace(run)
        count_order_paths(ws, sizes, srows[..., COLS_3D - 2], k4_order_paths,
                          f"suppress_pack_3d ({label})")
        return out

    def k4_match(iou, srows, max_det, label):
        got = k4_call(lambda: gpu_suppress3d.suppress_pack_3d(iou, srows, 0.01, max_det), srows,
                      label)
        want = gpu_suppress3d.suppress_pack_3d_reference(iou, srows, 0.01, max_det)
        torch.cuda.synchronize()
        check(torch.equal(got[1], want[1]) and torch.equal(bits(got[0]), bits(want[0])),
              f"suppress_pack_3d differs ({label})")

    for i, kind in enumerate(kernel_cases.SUPPRESS3D_KINDS):
        boxes, scores, labels = on_card(*kernel_cases.suppress3d_inputs(kind, K_3D, seed=60 + i))
        iou, srows = gpu_suppress3d.sorted_candidates(boxes, scores, labels)
        rows, keep = k4_call(lambda: gpu_suppress3d.fused_suppress_pack_3d(
            boxes, scores, labels, 0.01, MAX_DET_3D), srows, kind)
        want_rows, want_keep = gpu_suppress3d.suppress_pack_3d_reference(
            iou, srows, 0.01, MAX_DET_3D
        )
        torch.cuda.synchronize()
        check(torch.equal(keep, want_keep), f"suppress_pack_3d keep differs ({kind})")
        check(torch.equal(bits(rows), bits(want_rows)), f"suppress_pack_3d rows differ ({kind})")
        k4_cases += 1
        # the same candidates shuffled: the order pass sorts them
        perm = torch.from_numpy(np.random.default_rng(61 + i).permutation(K_3D)).to(dev)
        k4_match(iou[:, perm][:, :, perm].contiguous(), srows[:, perm].contiguous(),
                 MAX_DET_3D, f"{kind}, shuffled")
        k4_cases += 1
        if kind == "nan":
            check(not keep.any(), "suppress_pack_3d kept a row beside a live NaN")
    iou, srows = on_card(*kernel_cases.planted_iou(K_3D, seed=70))  # IoU == the threshold
    k4_match(iou, srows, MAX_DET_3D, "at the threshold")
    k4_cases += 1
    # K past one group of 32 mask words, up to the largest K taken
    check(gpu_suppress3d.smem_fits(K_LARGEST, COLS_3D)
          and not gpu_suppress3d.smem_fits(K_LARGEST + 1, COLS_3D),
          f"suppress_pack_3d does not take K up to {K_LARGEST} exactly")
    for k, max_dets in ((1300, (1300,)), (K_LARGEST, (MAX_DET_3D, K_LARGEST))):
        iou, srows = on_card(*kernel_cases.sparse_iou(k, 4.0 / k, seed=71))
        perm = torch.from_numpy(np.random.default_rng(72).permutation(k)).to(dev)
        shuffled = iou[:, perm][:, :, perm].contiguous(), srows[:, perm].contiguous()
        for max_det in max_dets:
            k4_match(iou, srows, max_det, f"sparse, K {k}, max_det {max_det}")
            k4_match(*shuffled, max_det, f"sparse, K {k}, max_det {max_det}, shuffled")
            k4_cases += 2
        del iou, srows, shuffled
    check(min(k4_order_paths.values()) > 0, f"an order path was not taken: {k4_order_paths}")
    n_big = K_LARGEST + 1  # past the largest K the wrapper takes: raises, launches nothing
    before = gpu_suppress3d.launches.count
    try:
        gpu_suppress3d.suppress_pack_3d(torch.zeros((1, 1, 1), device=dev).expand(1, n_big, n_big),
                                        torch.zeros((1, n_big, COLS_3D), device=dev))
        raised = False
    except ValueError:
        raised = True
    check(raised and gpu_suppress3d.launches.count == before,
          "suppress_pack_3d past shared memory did not raise on the card")
    emit("kernels_vs_plain_3d", card, kernels=[
        {"name": "residual_decode_3d", "cases": len(kernel_cases.DECODE3D_KINDS),
         "gathered_cases": len(kernel_cases.DECODE3D_KINDS) * len(kernel_cases.DIR_KINDS),
         "shape": [1, K_3D, 7], "gathered_from": [1, N_ANCHORS_3D, 7], "match": True,
         "max_abs_err": 0.0},
        {"name": "suppress_pack_3d", "cases": k4_cases, "shape": [1, K_3D, MAX_DET_3D, COLS_3D],
         "largest_k": K_LARGEST, "images_by_order_path": k4_order_paths,
         "match": True, "max_abs_err": 0.0},
    ])

    # -- 8. the main path: full-width KITTI PointPillars through the channel ----
    repo = ModelRepository()
    pipes = {}
    for name, fused in (("pointpillars", "auto"), ("pointpillars_unfused", "off")):
        pipe, spec, model = build_pointpillars_pipeline(
            config=Detect3DConfig(model_name=name, fused=fused), device="cuda", seed=0
        )  # one seed: both hold the same weights
        repo.register(spec, pipe.infer_fn(), warmup=pipe.warmup)  # a graph a point bucket
        pipes[name] = (pipe, spec, model)
    check(pipes["pointpillars"][1].extra["fused_stages"] == ["decode_nms"], "auto did not fuse")
    check(pipes["pointpillars_unfused"][1].extra["fused_stages"] == [], "off still fused")
    pipe, spec, model = pipes["pointpillars"]
    check(model.cfg.voxel.grid_size == (432, 496, 1) and pipe.use_scatter, "not the KITTI grid")
    channel = CUDAChannel(repo)
    channel.register_channel()
    infer = {name: channel_infer3d(channel, name) for name in pipes}
    scans = {
        n: [f.data for f in SyntheticPointCloudSource(3, points=n, seed=i)]
        for i, n in enumerate(SCAN_POINTS)
    }
    for name in pipes:
        repo.get(name).warmup()
    SERVED["pointpillars"] = {"pipes": pipes, "repo": repo, "channel": channel, "scans": scans}
    for name in pipes:  # warm-up, not counted
        for n in SCAN_POINTS:
            infer[name](scans[n][0])
    torch.cuda.synchronize()
    for counter in counters:
        counter.reset()
    out = {n: [infer["pointpillars"](pc) for pc in scans[n]] for n in SCAN_POINTS}
    repeat = infer["pointpillars"](scans[SCAN_POINTS[1]][0])
    fused_requests = sum(len(v) for v in scans.values()) + 1
    before = [gpu_decode3d.launches.count, gpu_suppress3d.launches.count]
    unfused = {n: infer["pointpillars_unfused"](scans[n][0]) for n in SCAN_POINTS}
    after = [gpu_decode3d.launches.count, gpu_suppress3d.launches.count]
    launches = {c_name: c.count for c_name, c in
                (("residual_decode_3d", gpu_decode3d.launches),
                 ("suppress_pack_3d", gpu_suppress3d.launches))}
    gathered = gpu_decode3d.gathered_launches.count
    check(before == after, "the unfused route launched a 3D kernel")
    for k_name, count in launches.items():
        check(count == fused_requests,
              f"{k_name} launched {count} times for {fused_requests} fused requests")
    check(gathered == fused_requests,
          f"kernel 3's gathered form launched {gathered} times for {fused_requests} requests")
    kept = {}
    for n in SCAN_POINTS:
        for o in out[n]:
            check(o["pred_boxes"].shape[1] == 7 and bool(np.isfinite(o["pred_boxes"]).all()),
                  "non-finite or misshapen boxes")
            check(len(o["pred_scores"]) <= MAX_DET_3D and o["pred_labels"].min() >= 1, "rows")
        kept[n] = [len(o["pred_scores"]) for o in out[n]]
        check(min(kept[n]) > 0, f"no detection kept at {n} points")
        for key in unfused[n]:  # fused rows equal the unfused ones, by value
            check(np.array_equal(out[n][0][key], unfused[n][key]), f"fused != unfused {key} ({n})")
    for key in repeat:
        check(np.array_equal(repeat[key], out[SCAN_POINTS[1]][0][key]),
              f"the same scan twice gave other {key}")
    bitwise_repeat = all(repeat[k].tobytes() == out[SCAN_POINTS[1]][0][k].tobytes() for k in repeat)
    # live candidates: the gate + top-k of the same scans, launching nothing
    live = {}
    with torch.no_grad():
        for n in SCAN_POINTS:
            padded, m = prepare_points(scans[n][0], 4, Detect3DConfig().point_buckets)
            heads = model.from_points(torch.from_numpy(padded).to(dev),
                                      torch.tensor(m, dtype=torch.int32, device=dev))
            cand = model.topk_candidates(heads, K_3D, Detect3DConfig().score_thresh)
            live[n] = int(torch.isfinite(cand["scores"]).sum())
            check(live[n] > 0, f"no live candidate at {n} points")
    emit("main_path_3d", card, model="pointpillars", grid=list(model.cfg.voxel.grid_size),
         anchors=int(model.anchors.shape[0]), points=list(SCAN_POINTS),
         requests={"fused": fused_requests, "unfused": len(unfused)},
         live_candidates=live, kept=kept, fused_equals_unfused=True,
         repeat_equal=True, repeat_bitwise=bitwise_repeat, launches=launches,
         launches_gathered_form=gathered,
         deterministic_sum_route="index_put_(accumulate=True), models/pointpillars.pillar_sums")

    # -- 9. kernels on the main path's own candidates; the card against the CPU --
    with torch.no_grad():
        padded, m = prepare_points(scans[SCAN_POINTS[1]][1], 4, Detect3DConfig().point_buckets)
        heads = model.from_points(torch.from_numpy(padded).to(dev),
                                  torch.tensor(m, dtype=torch.int32, device=dev))
        cand = model.topk_candidates(heads, K_3D, Detect3DConfig().score_thresh)
        sel = model.topk_indices(heads, K_3D, Detect3DConfig().score_thresh)
    dec_args = (cand["deltas"], cand["anchors"], cand["dir_bin"])
    gather_args = gathered_decode_args(model, heads, sel["top_idx"])
    check(gather_args[0].shape[1] == N_ANCHORS_3D, "not the KITTI head's anchors")
    boxes = gpu_decode3d.gather_residual_decode(*gather_args)
    decode_match(boxes, gpu_decode3d.gather_residual_decode_reference(*gather_args),
                 "main path, gathered")
    decode_match(gpu_decode3d.fused_residual_decode(*dec_args),
                 gpu_decode3d.residual_decode_reference(*dec_args), "main path")
    check(torch.equal(bits(boxes), bits(gpu_decode3d.residual_decode_reference(*dec_args))),
          "the gathered form differs from the ungathered chain on the main path")
    iou, srows = gpu_suppress3d.sorted_candidates(boxes, cand["scores"], cand["labels"])
    # sorted_candidates hands them over in score order: taken as it stands
    got, ws, sizes = with_workspace(
        lambda: gpu_suppress3d.suppress_pack_3d(iou, srows, 0.01, MAX_DET_3D))
    check(bool(mask_scan.took_own_order(ws, sizes).all()),
          "the order pass sorted the main path's 3D candidates")
    k4_workspace_bytes = ws.numel()
    del ws
    want = gpu_suppress3d.suppress_pack_3d_reference(iou, srows, 0.01, MAX_DET_3D)
    check(torch.equal(got[1], want[1]) and torch.equal(bits(got[0]), bits(want[0])),
          "suppress_pack_3d differs on the main path's candidates")
    # the tiny grid of tests/test_pointpillars.py, same seed on both devices
    tiny = PointPillarsConfig(
        voxel=VoxelConfig(point_cloud_range=(0.0, -6.4, -3.0, 12.8, 6.4, 1.0),
                          voxel_size=(0.2, 0.2, 4.0), max_voxels=512, max_points_per_voxel=8),
        backbone_layers=(1, 1, 1),
    )
    tiny_cfg = Detect3DConfig(point_buckets=(2048,), max_det=16, pre_max=64)
    card_pipe, _, _ = build_pointpillars_pipeline(tiny, tiny_cfg, device="cuda", seed=0)
    cpu_pipe, _, _ = build_pointpillars_pipeline(tiny, dc.replace(tiny_cfg, fused="on"),
                                                 device="cpu", seed=0)
    tiny_err, tiny_kept = card_vs_cpu(
        card_pipe, cpu_pipe, uniform_clouds(9, tiny.voxel.point_cloud_range, 500)
    )
    nan_cells = nan_cells_card_vs_cpu(dev)
    # one NaN x wipes every score on both devices, as in the JAX package
    nan_pc = uniform_clouds(9, tiny.voxel.point_cloud_range, 500)[0]
    nan_pc[7, 0] = np.nan
    nan_kept = [len(p.infer(nan_pc)["pred_scores"]) for p in (card_pipe, cpu_pipe)]
    check(nan_kept == [0, 0], f"a NaN point kept {nan_kept} detections (card, CPU), want 0")
    emit("check_3d", card, kernels_equal_plain_on_main_path=True, candidates=int(
        torch.isfinite(cand["scores"]).sum()), kept=int(got[1].sum()),
        cpu_vs_card_kept=tiny_kept, cpu_vs_card_max_abs_err=tiny_err,
        nan_cells_card_equals_cpu=nan_cells, nan_point_kept_card_cpu=nan_kept)

    # -- 10. times on the card's clock ---------------------------------------------
    # kernel 3 as the main path launches it (gathered) and in the TPU
    # kernel's form on the rows topk_candidates gathers
    k3_call_ms = cuda_ms(lambda: gpu_decode3d.gather_residual_decode(*gather_args), reps=500)
    k3_ms = kernel_device_ms(lambda: gpu_decode3d.gather_residual_decode(*gather_args),
                             gpu_decode3d.launches)
    k3_plain_ms = cuda_ms(lambda: gpu_decode3d.gather_residual_decode_reference(*gather_args),
                          reps=100)
    k3_rows_ms = kernel_device_ms(lambda: gpu_decode3d.fused_residual_decode(*dec_args),
                                  gpu_decode3d.launches)
    k4_call_ms = cuda_ms(lambda: gpu_suppress3d.suppress_pack_3d(iou, srows, 0.01, MAX_DET_3D),
                         reps=200)
    k4_ms = kernel_device_ms(lambda: gpu_suppress3d.suppress_pack_3d(iou, srows, 0.01, MAX_DET_3D),
                             gpu_suppress3d.launches)
    k4_plain_ms = cuda_ms(
        lambda: gpu_suppress3d.suppress_pack_3d_reference(iou, srows, 0.01, MAX_DET_3D),
        reps=5, warmup=1,
    )
    tests, kept_steps = live_counts_3d(iou, srows[..., COLS_3D - 2].clone(),
                                       torch.tensor(0.01, device=dev), MAX_DET_3D)
    n_cand = K_3D  # B = 1
    nb = model.cfg.num_dir_bins
    # each candidate's box-head row, anchor and direction logits, its
    # index, its box written
    k3_bytes = n_cand * (7 * 4 + 7 * 4 + 4 * nb + 8 + 7 * 4)
    # the IoU rows of the kept steps, the sorted rows, the packed output
    k4_bytes = kept_steps * K_3D * 4 + K_3D * COLS_3D * 4 + MAX_DET_3D * (COLS_3D * 4 + 1)
    k3_bound, k3_by = roofline(k3_bytes, n_cand * (DECODE_OPS + nb - 1))  # and the argmax
    k4_bound, k4_by = roofline(k4_bytes, tests)  # one compare per live candidate a step

    e2e = {f"points{n}": serve(infer["pointpillars"], scans[n], SERVE_REQUESTS_3D)
           for n in SCAN_POINTS}
    k4_passes = pass_split(
        lambda: gpu_suppress3d.suppress_pack_3d(iou, srows, 0.01, MAX_DET_3D), "suppress_pack_3d"
    )
    emit("passes_3d", card, kernel="suppress_pack_3d", shape=[1, K_3D, MAX_DET_3D, COLS_3D],
         kept=int(got[1].sum()), workspace_bytes=k4_workspace_bytes,
         **k4_passes)
    emit("times_3d", card,
         kernel_ms={"residual_decode_3d": k3_ms, "suppress_pack_3d": k4_ms},
         kernel_ms_ungathered_form={"residual_decode_3d": k3_rows_ms},
         call_ms={"residual_decode_3d": k3_call_ms, "suppress_pack_3d": k4_call_ms},
         plain_ms={"residual_decode_3d": k3_plain_ms, "suppress_pack_3d": k4_plain_ms},
         bound_ms={"residual_decode_3d": k3_bound, "suppress_pack_3d": k4_bound},
         live_tests=tests, kept_steps=kept_steps, in_process=e2e)

    # -- 11. where a 120k-point request's time goes -------------------------------
    pc = scans[SCAN_POINTS[1]][0]
    emit("profile_3d", card, points=SCAN_POINTS[1],
         **device_profile(lambda: infer["pointpillars"](pc), PROFILE_REQUESTS),
         candidate_stage=candidate_stage(model, heads, sel["top_idx"]))

    return [
        {"name": "residual_decode_3d", "route": "cuda",
         "source": "triton_client_tpu_torch/csrc/residual_decode_3d.cu",
         "replaces": "triton_client_tpu/ops/pallas_decode.py:233",
         "launches": launches["residual_decode_3d"], "max_abs_err": 0.0, "match": True,
         "ms": k3_ms, "call_ms": k3_call_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
         "bound_by": k3_by, "form": "gathered", "ms_ungathered_form": k3_rows_ms,
         "launches_gathered_form": gathered,
         "library_ms": None, "card": card},
        {"name": "suppress_pack_3d", "route": "cuda",
         "source": "triton_client_tpu_torch/csrc/suppress_pack_3d.cu",
         "replaces": "triton_client_tpu/ops/pallas_decode.py:321",
         "launches": launches["suppress_pack_3d"], "max_abs_err": 0.0, "match": True,
         "ms": k4_ms, "call_ms": k4_call_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound,
         "bound_by": k4_by, "passes_us": k4_passes["us"],
         "workspace_bytes": k4_workspace_bytes,
         "library_ms": None, "card": card},
    ]


def run_second(card: str, dev: torch.device, counters) -> tuple[list[dict], dict]:
    """Phases 12-16: the SECOND-IoU path (dense middle), kernel 5 new and
    kernels 3-4 on its tail. ``counters`` are every kernel's launch
    counters, all set to 0 just before the main path. Returns the segment
    mean's row of the ``{"kernels": [...]}`` record and the main path's
    launch counts of every 3D kernel."""
    import dataclasses as dc

    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.drivers.driver import channel_infer3d
    from triton_client_tpu_torch.io.sources import SyntheticPointCloudSource
    from triton_client_tpu_torch.models.second import SECONDConfig
    from triton_client_tpu_torch.ops import gpu_decode3d, gpu_suppress3d, gpu_voxel, kernel_cases
    from triton_client_tpu_torch.ops.voxelize import VoxelConfig, assign_cells, linearize_zyx
    from triton_client_tpu_torch.pipelines.detect3d import (
        Detect3DConfig,
        build_second_pipeline,
        gathered_decode_args,
        prepare_points,
    )
    from triton_client_tpu_torch.runtime.repository import ModelRepository

    k5_err = 0.0  # the largest |kernel - plain| over every comparison below

    def segment_match(valsT, slots, label):
        nonlocal k5_err
        got = gpu_voxel.sorted_segment_mean(valsT, slots, SECOND_SLOTS)
        want = gpu_voxel.sorted_segment_mean_reference(valsT, slots, SECOND_SLOTS)
        torch.cuda.synchronize()
        check(torch.equal(bits(got), bits(want)), f"segment_mean differs ({label})")
        k5_err = max(k5_err, float((got - want).abs().max()))

    # -- 12. the segment mean against its plain version, on the card ------------
    n_main = Detect3DConfig().point_buckets[-1]  # the 120k-point scan's bucket
    for i, kind in enumerate(kernel_cases.SEGMENT_KINDS):
        n = 4096 if kind == "one_slot" else n_main  # the plain version loops over the slot
        valsT, slots = (torch.from_numpy(a).to(dev)
                        for a in kernel_cases.segment_inputs(kind, n, SECOND_SLOTS, seed=80 + i))
        segment_match(valsT, slots, kind)
    before = gpu_voxel.launches.count
    try:  # a strided view is refused, launching nothing
        gpu_voxel.sorted_segment_mean(torch.zeros((n_main, 8), device=dev).T,
                                      torch.zeros(n_main, dtype=torch.int32, device=dev), 4)
        raised = False
    except ValueError:
        raised = True
    check(raised and gpu_voxel.launches.count == before, "a strided valsT did not raise")
    emit("kernels_vs_plain_second", card, kernels=[
        {"name": "segment_mean", "cases": len(kernel_cases.SEGMENT_KINDS),
         "shape": [8, n_main, SECOND_SLOTS], "match": True, "max_abs_err": k5_err},
    ])

    # -- 13. the main path: full-width KITTI SECOND-IoU through the channel -----
    repo = ModelRepository()
    pipes = {}
    for name, fused in (("second_iou", "auto"), ("second_iou_unfused", "off")):
        pipe, spec, model = build_second_pipeline(
            config=Detect3DConfig(model_name=name, fused=fused), device="cuda", seed=0
        )  # one seed: both hold the same weights
        repo.register(spec, pipe.infer_fn(), warmup=pipe.warmup)  # a graph a point bucket
        pipes[name] = (pipe, spec, model)
    check(pipes["second_iou"][1].extra["fused_stages"] == ["voxelize_scatter", "decode_nms"],
          "auto did not fuse both SECOND stages")
    check(pipes["second_iou_unfused"][1].extra["fused_stages"] == [], "off still fused")
    pipe, spec, model = pipes["second_iou"]
    voxel = model.cfg.voxel
    check(voxel.grid_size == (352, 400, 10) and voxel.max_voxels == SECOND_SLOTS
          and pipe.use_scatter, "not the KITTI SECOND grid")
    channel = CUDAChannel(repo)
    channel.register_channel()
    infer = {name: channel_infer3d(channel, name) for name in pipes}
    scans = {
        n: [f.data for f in SyntheticPointCloudSource(3, points=n, seed=20 + i)]
        for i, n in enumerate(SCAN_POINTS)
    }
    for name in pipes:
        repo.get(name).warmup()
    SERVED["second_iou"] = {"pipes": pipes, "repo": repo, "channel": channel, "scans": scans}
    for name in pipes:  # warm-up, not counted
        for n in SCAN_POINTS:
            infer[name](scans[n][0])
    torch.cuda.synchronize()
    for counter in counters:
        counter.reset()
    out = {n: [infer["second_iou"](pc) for pc in scans[n]] for n in SCAN_POINTS}
    repeat = infer["second_iou"](scans[SCAN_POINTS[1]][0])
    fused_requests = sum(len(v) for v in scans.values()) + 1
    kernels_3d = (("segment_mean", gpu_voxel.launches),
                  ("residual_decode_3d", gpu_decode3d.launches),
                  ("suppress_pack_3d", gpu_suppress3d.launches))
    before = [c.count for _, c in kernels_3d]
    unfused = {n: infer["second_iou_unfused"](scans[n][0]) for n in SCAN_POINTS}
    launches = {k_name: c.count for k_name, c in kernels_3d}
    all_launches = [c.count for c in counters[:-1]]  # each kernel once
    check(before == list(launches.values()), "the unfused route launched a kernel")
    for k_name, count in launches.items():
        check(count == fused_requests,
              f"{k_name} launched {count} times for {fused_requests} fused requests")
    check(sum(all_launches) == 3 * fused_requests, "a 2D kernel launched on the SECOND path")
    gathered = gpu_decode3d.gathered_launches.count
    check(gathered == fused_requests,
          f"kernel 3's gathered form launched {gathered} times for {fused_requests} requests")

    kept = {}
    for n in SCAN_POINTS:
        for o in out[n]:
            check(o["pred_boxes"].shape[1] == 7 and bool(np.isfinite(o["pred_boxes"]).all()),
                  "non-finite or misshapen boxes")
            check(len(o["pred_scores"]) <= MAX_DET_3D and o["pred_labels"].min() >= 1, "rows")
        kept[n] = [len(o["pred_scores"]) for o in out[n]]
        check(min(kept[n]) > 0, f"no detection kept at {n} points")
    for key in repeat:
        check(repeat[key].tobytes() == out[SCAN_POINTS[1]][0][key].tobytes(),
              f"the same scan twice gave other {key}")
    # below the cap, fused rows equal the unfused ones within 1e-5
    small = SCAN_POINTS[0]
    f0, u0 = out[small][0], unfused[small]
    check(len(f0["pred_scores"]) == len(u0["pred_scores"]), "fused and unfused keep other counts")
    check(np.array_equal(f0["pred_labels"], u0["pred_labels"]), "fused and unfused labels differ")
    fu_err = max(float(np.abs(f0[k] - u0[k]).max(initial=0.0))
                 for k in ("pred_boxes", "pred_scores"))
    check(fu_err <= 1e-5, f"fused and unfused rows differ by {fu_err} at {small} points")
    fu_bitwise = all(f0[k].tobytes() == u0[k].tobytes() for k in f0)
    big = SCAN_POINTS[1]
    big_differs = any(out[big][0][k].tobytes() != unfused[big][k].tobytes() for k in unfused[big])

    # occupied and kept cells, the live candidates (launches here are not counted)
    cells, live = {}, {}
    with torch.no_grad():
        for n in SCAN_POINTS:
            padded, m = prepare_points(scans[n][0], 4, Detect3DConfig().point_buckets)
            pts = torch.from_numpy(padded).to(dev)
            cnt = torch.tensor(m, dtype=torch.int32, device=dev)
            vid, n_cells = linearize_zyx(*assign_cells(pts, cnt, voxel), voxel)
            occupied = int(torch.unique(vid[vid < n_cells]).numel())
            volume = gpu_voxel.fused_mean_volume(pts, cnt, voxel)
            kept_cells = int((volume != 0).any(-1).sum())
            check(kept_cells == min(occupied, SECOND_SLOTS),
                  f"{n} points: {occupied} occupied cells, the fused route kept {kept_cells}")
            cells[n] = {"occupied": occupied, "kept": kept_cells, "bucket": int(padded.shape[0])}
            cand = model.topk_candidates(model.from_volume(volume), K_3D,
                                         Detect3DConfig().score_thresh)
            live[n] = int(torch.isfinite(cand["scores"]).sum())
            check(live[n] > 0, f"no live candidate at {n} points")
    check(cells[SCAN_POINTS[0]]["occupied"] < SECOND_SLOTS, "the small scan does not fit the cap")
    check(cells[big]["kept"] == SECOND_SLOTS, "the 120k scan did not fill the cap")
    emit("main_path_second", card, model="second_iou", grid=list(voxel.grid_size),
         max_voxels=voxel.max_voxels, anchors=int(model.anchors.shape[0]),
         points=list(SCAN_POINTS), requests={"fused": fused_requests, "unfused": len(unfused)},
         cells=cells, live_candidates=live, kept=kept,
         fused_equals_unfused={str(small): True, "max_abs_err": fu_err, "bitwise": fu_bitwise,
                               f"differs_at_{big}": big_differs},
         repeat_bitwise=True, launches=launches, launches_gathered_form=gathered,
         deterministic_sum_route="index_put_(accumulate=True), models/pointpillars.pillar_sums")

    # -- 14. kernels on the main path's own inputs; the card against the CPU -----
    with torch.no_grad():
        padded, m = prepare_points(scans[big][1], 4, Detect3DConfig().point_buckets)
        pts = torch.from_numpy(padded).to(dev)
        cnt = torch.tensor(m, dtype=torch.int32, device=dev)
        valsT, slots, _ = gpu_voxel.slot_rows(pts, cnt, voxel)
        segment_match(valsT, slots, "main path")
        heads = model.from_volume(gpu_voxel.fused_mean_volume(pts, cnt, voxel))
        cand = model.topk_candidates(heads, K_3D, Detect3DConfig().score_thresh)
        sel = model.topk_indices(heads, K_3D, Detect3DConfig().score_thresh)
    dec_args = (cand["deltas"], cand["anchors"], cand["dir_bin"])
    gather_args = gathered_decode_args(model, heads, sel["top_idx"])
    boxes = gpu_decode3d.gather_residual_decode(*gather_args)
    check(torch.equal(bits(boxes),
                      bits(gpu_decode3d.gather_residual_decode_reference(*gather_args))),
          "residual_decode_3d's gathered form differs on SECOND's candidates")
    check(torch.equal(bits(gpu_decode3d.fused_residual_decode(*dec_args)),
                      bits(gpu_decode3d.residual_decode_reference(*dec_args))),
          "residual_decode_3d differs on SECOND's candidates")
    check(torch.equal(bits(boxes), bits(gpu_decode3d.residual_decode_reference(*dec_args))),
          "the gathered form differs from the ungathered chain on SECOND's candidates")
    check(torch.equal(sel["scores"], cand["scores"]) and torch.equal(sel["labels"], cand["labels"]),
          "topk_indices and topk_candidates select differently")
    iou, srows = gpu_suppress3d.sorted_candidates(boxes, cand["scores"], cand["labels"])
    got = gpu_suppress3d.suppress_pack_3d(iou, srows, 0.01, MAX_DET_3D)
    want = gpu_suppress3d.suppress_pack_3d_reference(iou, srows, 0.01, MAX_DET_3D)
    check(torch.equal(got[1], want[1]) and torch.equal(bits(got[0]), bits(want[0])),
          "suppress_pack_3d differs on SECOND's candidates")
    # the tiny grid of tests/test_torch_second.py, same seed on both devices
    tiny = SECONDConfig(
        voxel=VoxelConfig(point_cloud_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0),
                          voxel_size=(0.5, 0.5, 0.5), max_voxels=1024, max_points_per_voxel=5),
        middle_filters=(8, 16), backbone_layers=(1, 1), backbone_filters=(16, 32),
        upsample_filters=(16, 16),
    )
    tiny_cfg = Detect3DConfig(model_name="second_iou", point_buckets=(1024,), max_det=16,
                              pre_max=64)
    card_pipe, _, _ = build_second_pipeline(tiny, tiny_cfg, device="cuda", seed=0)
    cpu_pipe, _, _ = build_second_pipeline(tiny, dc.replace(tiny_cfg, fused="on"),
                                           device="cpu", seed=0)
    check(card_pipe.fused_stages == cpu_pipe.fused_stages, "card and CPU route differently")
    tiny_err, tiny_kept = card_vs_cpu(
        card_pipe, cpu_pipe, uniform_clouds(11, tiny.voxel.point_cloud_range, 600)
    )
    emit("check_second", card, kernels_equal_plain_on_main_path=True,
         segment_rows=int(slots.numel()), live_rows=int((slots < SECOND_SLOTS).sum()),
         candidates=int(torch.isfinite(cand["scores"]).sum()), kept=int(got[1].sum()),
         cpu_vs_card_kept=tiny_kept, cpu_vs_card_max_abs_err=tiny_err)

    # -- 15. times on the card's clock ---------------------------------------------
    def k5():
        return gpu_voxel.sorted_segment_mean(valsT, slots, SECOND_SLOTS)

    k5_call_ms = cuda_ms(k5, reps=200)
    k5_ms = kernel_device_ms(k5, gpu_voxel.launches)
    k5_plain_ms = cuda_ms(
        lambda: gpu_voxel.sorted_segment_mean_reference(valsT, slots, SECOND_SLOTS), reps=20
    )
    # the library yardstick: one index_reduce_ "mean" over the live rows
    # (a prefix: the dump rows sort last), as (rows, 8) with int64 ids
    n_live = int((slots < SECOND_SLOTS).sum())
    rows_aos = valsT[:, :n_live].T.contiguous()
    ids = slots[:n_live].long()
    lib_out = torch.zeros((SECOND_SLOTS, 8), device=dev)

    def library():
        return lib_out.index_reduce_(0, ids, rows_aos, "mean", include_self=False)

    library_ms = cuda_ms(library, reps=200)
    # index_reduce_ divides by the row count; the weights here are all 1
    check(torch.allclose(library().T, k5(), rtol=1e-5, atol=0), "index_reduce_ disagrees")
    n_rows = valsT.shape[1]
    # what this run's rows need: the live rows' 8 values and slot id, each
    # read once, and 8 means a slot written; the dump rows are never read
    # (the zero launch's 8 x slots writes and the dump rows' ids, which the
    # row-parallel pass reads, are the design's cost, not counted)
    k5_bytes = 9 * n_live * 4 + 8 * SECOND_SLOTS * 4
    k5_ops = 8 * n_live + 8 * SECOND_SLOTS  # the adds this run's rows need, one division a mean
    k5_bound, k5_by = roofline(k5_bytes, k5_ops)

    e2e = {name: {f"points{n}": serve(infer[name], scans[n], SERVE_REQUESTS_3D)
                  for n in SCAN_POINTS}
           for name in pipes}
    k5_passes = pass_split(k5, "segment_mean", passes=("zero", "walk"))
    emit("passes_second", card, kernel="segment_mean", shape=[8, n_rows, SECOND_SLOTS],
         live_rows=n_live, **k5_passes)
    emit("times_second", card, kernel_ms={"segment_mean": k5_ms},
         call_ms={"segment_mean": k5_call_ms}, plain_ms={"segment_mean": k5_plain_ms},
         library_ms={"segment_mean": library_ms},
         library_call="Tensor.index_reduce_(0, ids, rows, 'mean', include_self=False)",
         bound_ms={"segment_mean": k5_bound}, bound_by={"segment_mean": k5_by},
         bytes=k5_bytes, ops=k5_ops, rows=n_rows, live_rows=n_live, in_process=e2e)

    # -- 16. where a 120k-point SECOND request's time goes -------------------------
    pc = scans[big][0]
    emit("profile_second", card, points=big,
         **device_profile(lambda: infer["second_iou"](pc), PROFILE_REQUESTS))

    return [
        {"name": "segment_mean", "route": "cuda",
         "source": "triton_client_tpu_torch/csrc/segment_mean.cu",
         "replaces": "triton_client_tpu/ops/pallas_voxel.py:194",
         "launches": launches["segment_mean"], "max_abs_err": k5_err, "match": True,
         "ms": k5_ms, "call_ms": k5_call_ms, "plain_ms": k5_plain_ms, "bound_ms": k5_bound,
         "bound_by": k5_by, "passes_us": k5_passes["us"], "library_ms": library_ms,
         "card": card},
    ], launches


def burst(chan, requests) -> tuple[list, list[float], float]:
    """``requests`` sent at once, one caller thread each, released by a
    barrier: the responses, each request's latency and the burst's wall
    (host clock). A caller's error fails the script."""
    import threading

    n = len(requests)
    out, lat, errors = [None] * n, [0.0] * n, []
    gate = threading.Barrier(n + 1)

    def call(i):
        try:
            gate.wait(timeout=60.0)
            t = time.perf_counter()
            out[i] = chan.do_inference(requests[i])
            lat[i] = time.perf_counter() - t
        except Exception as e:  # reported below, not swallowed
            errors.append(repr(e))

    threads = [threading.Thread(target=call, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    gate.wait(timeout=60.0)
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=120.0)
    wall = time.perf_counter() - t0
    check(not errors and all(not t.is_alive() for t in threads), f"burst failed: {errors[:3]}")
    return out, lat, wall


def run_ragged(card: str, dev: torch.device, counters) -> list[dict]:
    """Phases 17-20: packed ragged batches through the continuous batcher,
    kernel 6 new. ``counters`` are every kernel's launch counters, all set
    to 0 just before the main path. Returns the segment sum's row of the
    ``{"kernels": [...]}`` record."""
    import concurrent.futures

    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.io.sources import SyntheticPointCloudSource
    from triton_client_tpu_torch.models.pool import POOL_W, PoolModel, pool_spec
    from triton_client_tpu_torch.ops import gpu_segment, kernel_cases
    from triton_client_tpu_torch.parallel.ragged_kernels import (
        RaggedLayout,
        pack_rows,
        segment_reduce,
    )
    from triton_client_tpu_torch.runtime.continuous import ContinuousBatchingChannel
    from triton_client_tpu_torch.runtime.repository import ModelRepository

    k6_err = 0.0  # the largest |kernel - plain| over every comparison below

    def segsum_match(v, ids, s, label):
        nonlocal k6_err
        got = gpu_segment.segment_sum(v, ids, s)
        want = gpu_segment.segment_sum_reference(v, ids, s)
        torch.cuda.synchronize()
        check(torch.equal(bits(got), bits(want)), f"segment_sum differs ({label})")
        k6_err = max(k6_err, float((got - want).abs().max()) if got.numel() else 0.0)

    # -- 17. the segment sum against its plain version, on the card -------------
    for i, (kind, r, f, s) in enumerate(kernel_cases.SEGSUM_CASES):
        v, ids = (torch.from_numpy(a).to(dev)
                  for a in kernel_cases.segsum_inputs(kind, r, f, s, seed=90 + i))
        segsum_match(v, ids, s, f"{kind} R={r} F={f} S={s}")
    empty = gpu_segment.segment_sum(torch.ones((0, 4), device=dev),
                                    torch.zeros(0, dtype=torch.int32, device=dev), 8)
    check(empty.shape == (8, 4) and not bool(empty.any()), "R = 0 did not give zeros")
    check(gpu_segment.segment_sum(torch.ones((5, 4), device=dev),
                                  torch.zeros(5, dtype=torch.int32, device=dev), 0).shape == (0, 4),
          "S = 0")
    before = gpu_segment.launches.count
    try:  # mixed devices are refused, launching nothing
        gpu_segment.segment_sum(torch.ones((5, 4), device=dev),
                                torch.zeros(5, dtype=torch.int32), 2)
        raised = False
    except ValueError:
        raised = True
    check(raised and gpu_segment.launches.count == before, "mixed devices did not raise")
    v, ids = kernel_cases.segsum_inputs("out_of_range", kernel_cases.SEGSUM_MAIN_ROWS, 4, 8,
                                        seed=99)
    reduce_ops = {}
    for op in ("sum", "mean", "max", "min"):
        got = segment_reduce(torch.from_numpy(v).to(dev), torch.from_numpy(ids).to(dev), 8, op)
        want = segment_reduce(torch.from_numpy(v), torch.from_numpy(ids), 8, op)
        check(torch.equal(bits(got.cpu()), bits(want)), f"segment_reduce {op}: card != plain route")
        reduce_ops[op] = True
    emit("kernels_vs_plain_ragged", card, kernels=[
        {"name": "segment_sum", "cases": len(kernel_cases.SEGSUM_CASES), "match": True,
         "max_abs_err": k6_err, "shapes": [list(c[1:]) for c in kernel_cases.SEGSUM_CASES]},
    ], segment_reduce_equals_plain_route=reduce_ops)

    # -- 18. the main path: packed ragged batches through the continuous batcher --
    rng = np.random.default_rng(17)
    sizes = [int(n) for n in rng.integers(RAGGED_POINTS[0], RAGGED_POINTS[1] + 1, RAGGED_CLOUDS)]
    clouds = [next(iter(SyntheticPointCloudSource(1, points=n, seed=40 + i))).data
              for i, n in enumerate(sizes)]
    biases = [rng.standard_normal((1, 4)).astype(np.float32) for _ in sizes]
    model = PoolModel("cuda")
    solo_calls = [0]

    def counted_infer_fn(inputs):
        solo_calls[0] += 1
        return model.infer_fn(inputs)

    repo = ModelRepository()
    repo.register(pool_spec(), counted_infer_fn, ragged_fn=model.ragged_fn)
    inner = CUDAChannel(repo)  # the packed route captured (the default)
    inner.register_channel()
    eager_inner = CUDAChannel(repo, capture_ragged=False)  # the comparison leg only
    cont = ContinuousBatchingChannel(inner, max_batch=RAGGED_CLOUDS)
    burst_chan = ContinuousBatchingChannel(inner, max_batch=RAGGED_CLOUDS, pipeline_depth=1)
    # every packed request the captured channel runs, with its future
    packed_runs = []
    dispatch = inner.do_inference_async

    def recorded_dispatch(request):
        fut = dispatch(request)
        if request.ragged is not None:
            packed_runs.append((request, fut))
        return fut

    inner.do_inference_async = recorded_dispatch

    def requests():
        return [InferRequest("pool", {"points": c, "bias": b}, request_id=str(i))
                for i, (c, b) in enumerate(zip(clouds, biases))]

    def run_group(chan, members):
        reqs = requests()
        futs = [concurrent.futures.Future() for _ in members]
        chan._run_ragged_group([(None, reqs[i], f) for i, f in zip(members, futs)])
        return [f.result(timeout=120.0).outputs["pooled"] for f in futs]

    def captures():
        return sum(st["captures"] for st in inner.ragged_graph_stats().values())

    def captured_equals_eager(label):
        """Every recorded packed output against the eager route on the same
        packed request, bit for bit."""
        for request, fut in packed_runs:
            got = fut.result().outputs["pooled"]
            want = eager_inner.do_inference(request).outputs["pooled"]
            check(got.tobytes() == want.tobytes(),
                  f"{label}: a captured packed batch of {request.ragged.n_segments} differs "
                  "from the eager route")
        n = len(packed_runs)
        packed_runs.clear()
        return n

    everyone = list(range(RAGGED_CLOUDS))
    try:
        # warm-up, not counted: the graphs of the packed group and of the
        # bursts' usual groups (all eight, and one lone request with the
        # other seven packed) are captured here, outside every counted and
        # timed window
        run_group(cont, everyone)
        for lone in everyone:
            run_group(cont, [i for i in everyone if i != lone])
        inner.do_inference(requests()[0])
        burst(burst_chan, requests())
        torch.cuda.synchronize()
        packed_runs.clear()
        base_cont, base_burst = cont.stats(), burst_chan.stats()
        captures_before = captures()
        for counter in counters:
            counter.reset()
        solo_calls[0] = 0
        packed = run_group(cont, everyone)
        group_solo_calls = solo_calls[0]
        group_launches = gpu_segment.launches.count
        burst_out, _, _ = burst(burst_chan, requests())
        launches = {"segment_sum": gpu_segment.launches.count}
        all_launches = [c.count for c in counters[:-1]]  # each kernel once
        burst_solo_calls = solo_calls[0] - group_solo_calls
        s_cont, s_burst = cont.stats(), burst_chan.stats()
        captures_in_window = captures() - captures_before
        checked = captured_equals_eager("phase 18")
    finally:
        cont.close()
        burst_chan.close()
    keys = ("ragged_batches", "ragged_segments", "ragged_rows", "ragged_pad_rows",
            "ragged_fallbacks", "merge_fallbacks", "kernel_failures")
    group_stats = {k: s_cont[k] - base_cont[k] for k in keys}
    burst_stats = {k: s_burst[k] - base_burst[k] for k in keys}
    occ = {k: v - base_burst["merge_occupancy"].get(k, 0)
           for k, v in s_burst["merge_occupancy"].items()
           if v > base_burst["merge_occupancy"].get(k, 0)}
    lone, packs = occ.get(1, 0), sum(v for k, v in occ.items() if k > 1)
    layout = RaggedLayout(tuple(sizes))
    check(group_stats["ragged_batches"] == 1, f"the packed group counted {group_stats}")
    check(group_stats["ragged_rows"] == layout.total and group_stats["ragged_segments"] == 8,
          f"the packed group's stats {group_stats}")
    check(group_solo_calls == 0, f"infer_fn ran {group_solo_calls} times in the packed group")
    for label, st in (("packed group", group_stats), ("burst", burst_stats)):
        fell = {k: st[k] for k in ("ragged_fallbacks", "merge_fallbacks", "kernel_failures")}
        check(not any(fell.values()), f"the {label} fell back or failed: {fell}")
    check(group_launches == 1, f"segment_sum launched {group_launches} times for 1 packed group")
    check(burst_stats["ragged_batches"] >= 1, f"the burst never packed: {burst_stats}")
    # no silent fallback: lone groups ran solo, every larger group packed
    check(burst_stats["ragged_batches"] == packs and burst_solo_calls == lone,
          f"burst groups {occ}: {burst_stats['ragged_batches']} packed, {burst_solo_calls} solo")
    # a capture inside the window (a burst grouping the warm-up did not
    # see) adds its eager warmup calls' launches; the replays add one each
    from triton_client_tpu_torch.runtime.graphs import WARMUP_CALLS

    batches = group_stats["ragged_batches"] + burst_stats["ragged_batches"]
    in_replays = launches["segment_sum"] - WARMUP_CALLS * captures_in_window
    check(in_replays == batches,
          f"segment_sum launched {in_replays} times in replays for {batches} packed batches "
          f"({captures_in_window} captures in the window)")
    check(checked == batches, f"{checked} packed batches recorded for {batches}")
    check(sum(all_launches) == launches["segment_sum"],
          "another kernel launched on the ragged path")
    for o in packed + [r.outputs["pooled"] for r in burst_out]:
        check(o.shape == (4,) and bool(np.isfinite(o).all()), "non-finite or misshapen pooled")
    emit("main_path_ragged", card, model="pool", clouds=RAGGED_CLOUDS, points=sizes,
         packed_rows=layout.padded_rows, live_rows=layout.total, seg_bucket=layout.seg_bucket,
         requests={"packed_group": RAGGED_CLOUDS, "burst": RAGGED_CLOUDS},
         launches=launches, launches_in_replays=in_replays,
         captures_in_window=captures_in_window, captured_equals_eager_bitwise=checked,
         ragged_graphs=inner.ragged_graph_stats(),
         packed_group_stats=group_stats, burst_stats=burst_stats,
         burst_merge_occupancy=occ, infer_fn_calls={"packed_group": group_solo_calls,
                                                    "burst": burst_solo_calls},
         pad_fraction={"packed_group": s_cont["pad_fraction"], "burst": s_burst["pad_fraction"]})

    # -- 19. kernel 6 on the main path's own rows; members against float64 -------
    ids = torch.from_numpy(layout.segment_ids).to(dev)
    with torch.no_grad():
        feat = torch.tanh(torch.from_numpy(pack_rows(clouds, layout)).to(dev)
                          @ torch.from_numpy(POOL_W).to(dev))
    segsum_match(feat, ids, layout.launch_segments, "main path")
    w64 = POOL_W.astype(np.float64)
    solo = [inner.do_inference(r).outputs["pooled"] for r in requests()]
    cpu_repo = ModelRepository()
    cpu_model = PoolModel("cpu")
    cpu_repo.register(pool_spec(), cpu_model.infer_fn, ragged_fn=cpu_model.ragged_fn)
    cpu_cont = ContinuousBatchingChannel(CUDAChannel(cpu_repo, "cpu"))
    try:
        reqs = requests()
        futs = [concurrent.futures.Future() for _ in reqs]
        cpu_cont._run_ragged_group([(None, r, f) for r, f in zip(reqs, futs)])
        cpu_packed = [f.result(timeout=300.0).outputs["pooled"] for f in futs]
    finally:
        cpu_cont.close()
    worst = {"packed": 0.0, "solo": 0.0, "card_vs_cpu": 0.0}
    for i, (c, b) in enumerate(zip(clouds, biases)):
        terms = np.tanh(c.astype(np.float64) @ w64)
        want, bound = terms.sum(0) + b[0], 1e-6 * np.abs(terms).sum(0)
        for name, got in (("packed", packed[i]), ("solo", solo[i]),
                          ("card_vs_cpu", cpu_packed[i] - packed[i] + want)):
            ratio = float((np.abs(got - want) / bound).max())
            check(ratio <= 1.0, f"cloud {i} ({name}) is {ratio} x the float64 bound off")
            worst[name] = max(worst[name], ratio)
    emit("check_ragged", card, kernel_equals_plain_on_main_path=True,
         packed_rows=int(feat.shape[0]), bound="1e-6 x sum|tanh(points @ W)| per column",
         worst_error_over_bound=worst)

    # -- 20. times on the card's clock ---------------------------------------------
    s = layout.launch_segments

    def k6():
        return gpu_segment.segment_sum(feat, ids, s)

    k6_call_ms = cuda_ms(k6, reps=200)
    k6_ms = kernel_device_ms(k6, gpu_segment.launches)
    k6_plain_ms = cuda_ms(lambda: gpu_segment.segment_sum_reference(feat, ids, s), reps=3,
                          warmup=1)
    # its one launch's device time, as torch.profiler reports it; fails if
    # the profiler does not see the kernel by its name
    k6_passes = pass_split(k6, "segment_sum", passes=("chunks_fold",))
    total = layout.total  # index_add_ refuses the pad id: the pad rows are sliced off
    lib_ids, lib_v = ids[:total], feat[:total]

    def library():
        return torch.zeros((s, feat.shape[1]), device=dev).index_add_(0, lib_ids, lib_v)

    library_ms = cuda_ms(library, reps=200)
    # index_add_ adds with atomics in any order: held to the bound of a
    # sum of n terms in any order, (n - 1) x 2^-24 x sum|v|, n the rows
    lib_bound = (total * 2.0**-24) * torch.zeros((s, 4), device=dev).index_add_(
        0, lib_ids, lib_v.abs())
    check(bool(((library() - k6()).abs() <= lib_bound).all()), "index_add_ disagrees")
    # every row's id read once, the kept rows' values read once, the sums
    # written once; the pad rows' values are never needed
    k6_bytes = feat.shape[0] * 4 + total * feat.shape[1] * 4 + s * feat.shape[1] * 4
    k6_ops = total * feat.shape[1]  # one add a kept value
    k6_bound, k6_by = roofline(k6_bytes, k6_ops)

    # bursts through the batcher, the captured route against the eager one,
    # rounds interleaved, which leg goes first alternating; a round in which
    # a capture happened is discarded and run again, so no capture lands in
    # a timed window. The eager channel records its packed requests too, so
    # both legs carry the same bookkeeping
    eager_runs = []
    eager_dispatch = eager_inner.do_inference_async

    def eager_recorded(request):
        fut = eager_dispatch(request)
        if request.ragged is not None:
            eager_runs.append((request, fut))
        return fut

    eager_inner.do_inference_async = eager_recorded
    legs = {"captured": ContinuousBatchingChannel(inner, max_batch=RAGGED_CLOUDS,
                                                  pipeline_depth=1),
            "eager": ContinuousBatchingChannel(eager_inner, max_batch=RAGGED_CLOUDS,
                                               pipeline_depth=1)}
    timed = {leg: ([], 0.0) for leg in legs}
    discarded = 0
    try:
        for chan in legs.values():
            burst(chan, requests())  # warm-up
        rounds = 0
        while rounds < RAGGED_ROUNDS:
            order = list(legs.items()) if rounds % 2 == 0 else list(legs.items())[::-1]
            c0, taken = captures(), {}
            for leg, chan in order:
                _, ls, w = burst(chan, requests())
                taken[leg] = (ls, w)
            if captures() != c0:
                discarded += 1
                check(discarded <= RAGGED_ROUNDS, "bursts kept capturing new graphs")
                continue
            for leg, (ls, w) in taken.items():
                lat, wall = timed[leg]
                timed[leg] = (lat + ls, wall + w)
            rounds += 1
        stats = {leg: chan.stats() for leg, chan in legs.items()}
    finally:
        for chan in legs.values():
            chan.close()
    route_req = packed_runs[-1][0]  # a packed batch, as the batcher built it
    checked_timed = captured_equals_eager("phase 20")
    inner.do_inference_async, eager_inner.do_inference_async = dispatch, eager_dispatch
    eager_runs.clear()
    # the packed route alone, one caller, no batcher: captured against
    # eager on one packed request (legs interleaved), and where each
    # request's device time goes
    route = {leg: {"p50_ms": []} for leg in ("captured", "eager")}
    for _ in range(2):
        for leg, chan in (("captured", inner), ("eager", eager_inner)):
            route[leg]["p50_ms"].append(serve(lambda _r, c=chan: c.do_inference(route_req),
                                              [None], 30, "clouds_per_s",
                                              lambda _r: RAGGED_CLOUDS)["p50_ms"])
    for leg, chan in (("captured", inner), ("eager", eager_inner)):
        route[leg]["profile"] = device_profile(lambda c=chan: c.do_inference(route_req), 10)
    batched = {}
    for leg, (lat, wall) in timed.items():
        bs = stats[leg]
        check(bs["ragged_fallbacks"] == 0 and bs["kernel_failures"] == 0,
              f"a timed {leg} burst fell back or failed: {bs['ragged_fallbacks']} fallbacks, "
              f"{bs['kernel_failures']} kernel failures")
        batched[leg] = {"clouds_per_s": len(lat) / wall, "p50_ms": float(np.median(lat)) * 1e3,
                        "requests": len(lat), "ragged_batches": bs["ragged_batches"],
                        "ragged_fallbacks": bs["ragged_fallbacks"],
                        "merge_occupancy": bs["merge_occupancy"],
                        "decomp_ms": bs.get("decomp_ms")}
    batched["captured"]["rounds_discarded_for_a_capture"] = discarded
    batched["captured"]["packed_batches_equal_eager_bitwise"] = checked_timed
    solo_e2e = serve(inner.do_inference, requests(), RAGGED_ROUNDS * RAGGED_CLOUDS,
                     "clouds_per_s")
    emit("times_ragged", card, kernel_ms={"segment_sum": k6_ms},
         call_ms={"segment_sum": k6_call_ms}, plain_ms={"segment_sum": k6_plain_ms},
         library_ms={"segment_sum": library_ms},
         library_call="torch.zeros(S, F).index_add_(0, ids[:total], v[:total])",
         bound_ms={"segment_sum": k6_bound}, bound_by={"segment_sum": k6_by},
         passes=k6_passes,
         bytes=k6_bytes, ops=k6_ops, rows=int(feat.shape[0]), live_rows=total, segments=s,
         features=int(feat.shape[1]),
         in_process={"batcher_burst_of_8": batched["captured"],
                     "batcher_burst_of_8_eager": batched["eager"],
                     "packed_route_alone": route,
                     "solo_channel_one_caller": solo_e2e})

    return [
        {"name": "segment_sum", "route": "cuda",
         "source": "triton_client_tpu_torch/csrc/segment_sum.cu",
         "replaces": "triton_client_tpu/parallel/ragged_kernels.py:220",
         "launches": launches["segment_sum"], "max_abs_err": k6_err, "match": True,
         "ms": k6_ms, "call_ms": k6_call_ms, "plain_ms": k6_plain_ms, "bound_ms": k6_bound,
         "bound_by": k6_by, "passes_us": k6_passes["us"], "library_ms": library_ms,
         "in_graph": True, "card": card},
    ]


def run_dense_batched(card: str, counters, repo, channel, frames: np.ndarray) -> None:
    """Phase 21: YOLOv5n 512^2 through the continuous batcher's dense merged
    path (``repo`` and ``channel`` serve phase 3's models, ``frames`` are
    its frames). No kernel-6 launch may happen here."""
    import concurrent.futures

    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.ops import gpu_decode, gpu_segment
    from triton_client_tpu_torch.runtime.continuous import ContinuousBatchingChannel

    name = "yolov5n_c005"  # conf 0.05: every frame keeps detections, kernel 1 runs
    singles = [frames[i:i + 1] for i in range(B_MAIN)]
    stacked = np.concatenate(singles)
    direct = channel.do_inference(InferRequest(name, {"images": stacked})).outputs
    cont = ContinuousBatchingChannel(CUDAChannel(repo), max_batch=B_MAIN)
    try:
        for counter in counters:
            counter.reset()
        futs = [concurrent.futures.Future() for _ in singles]
        cont._run_group([(None, InferRequest(name, {"images": f}), fut)
                         for f, fut in zip(singles, futs)])
        merged = [fut.result(timeout=120.0).outputs for fut in futs]
        white_box = cont.stats()
        # one caller at a time: each frame is a group of one (batch 1)
        solo = [cont.do_inference(InferRequest(name, {"images": f})).outputs for f in singles]
        # 8 callers at once: the dispatcher merges what has queued
        burst_out, _, _ = burst(cont, [InferRequest(name, {"images": f}) for f in singles])
        stats = cont.stats()
        launches = {"decode_nms_2d": gpu_decode.launches.count,
                    "segment_sum": gpu_segment.launches.count}
    finally:
        cont.close()
    check(white_box["padded_frames"] == 0, "the white-box group of 8 was padded")
    fell = {k: stats[k] for k in ("merge_fallbacks", "kernel_failures")}
    check(not any(fell.values()), f"a merged YOLOv5n group fell back or failed: {fell}")
    check(launches["segment_sum"] == 0, "segment_sum launched on the dense path")
    check(launches["decode_nms_2d"] == 1 + stats["merges"],
          f"decode_nms_2d launched {launches['decode_nms_2d']} times for {1 + stats['merges']} "
          f"device calls")
    occ = stats["merge_occupancy"]
    check(sum(k * v for k, v in occ.items()) == 2 * B_MAIN, f"merge occupancy {occ}")
    kept = []
    top_err = 0.0
    for i, m in enumerate(merged):
        for key in ("detections", "valid"):
            check(m[key].tobytes() == direct[key][i:i + 1].tobytes(),
                  f"frame {i}: merged {key} differ from the direct stacked call")
        kept.append(int(m["valid"].sum()))
        # other batch sizes may take other cuDNN algorithms: phase 4's bar
        for o in (solo[i], burst_out[i].outputs):
            check(int(o["valid"].sum()) == kept[-1], f"frame {i}: kept count differs at batch "
                  f"{o['valid'].shape[0]}")
            err = float(np.abs(o["detections"][0, :5] - direct["detections"][i, :5]).max())
            top_err = max(top_err, err)
            check(np.allclose(o["detections"][0, :5], direct["detections"][i, :5], rtol=1e-2,
                              atol=1e-2), f"frame {i}: top rows differ by {err}")
    check(min(kept) > 0, "a frame kept no detection")
    emit("dense_batched_2d", card, model=name, input_hw=[512, 512], frames=B_MAIN,
         merged_equals_direct_bitwise=True, kept=kept, solo_and_burst_top5_max_abs_err=top_err,
         merge_occupancy=occ, padded_frames=stats["padded_frames"],
         pad_fraction=stats["pad_fraction"], live_bucket_table=stats["live_bucket_table"],
         launches=launches, **fell)


def request_profile(run, requests: int) -> dict:
    """``device_profile`` plus the device ops the host issued a request:
    the CUDA runtime calls that launch device work (``LAUNCH_APIS``: a
    captured request's ``cudaGraphLaunch`` and the copies around it, an
    eager request's every kernel), counted by torch.profiler."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(requests):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    device_ops = [e for e in events if e.device_type.name == "CUDA"]
    check(len(device_ops) > 0, "torch.profiler saw no device op")
    device_s = sum(e.device_time_total for e in device_ops) / 1e6
    issued: dict[str, int] = {}
    for e in events:
        if e.device_type.name == "CPU" and e.name in LAUNCH_APIS:
            issued[e.name] = issued.get(e.name, 0) + 1
    return {"requests": requests, "wall_ms_per_request": wall / requests * 1e3,
            "device_ms_per_request": device_s / requests * 1e3,
            "device_busy_share": device_s / wall, "device_ops_per_request": len(device_ops) / requests,
            "host_issued_ops_per_request": sum(issued.values()) / requests,
            "host_issued_by_call": {k: v / requests for k, v in sorted(issued.items())}}


def outputs_bitwise_equal(got, want) -> bool:
    return all(torch.equal(bits(g) if g.dtype == torch.float32 else g,
                           bits(e) if e.dtype == torch.float32 else e)
               for g, e in zip(got, want))


def hold_captured_to_eager(pipe, a, b, counters, label: str) -> tuple:
    """A pipeline's captured body (``pipe._jit``) against its eager body
    (``pipe.run``) on two inputs: ``GRAPH_REPLAYS`` replays on ``a``
    bitwise equal to one eager call and launching ``GRAPH_REPLAYS`` times
    its kernels, a replay on ``b`` giving ``b``'s result, the two results
    not equal, and no capture past the first call. Returns (eager launches
    a call per counter, eager outputs on a, on b)."""
    pipe._jit(*a)  # captures here unless captured at registration
    torch.cuda.synchronize()
    before = [c.count for c in counters]
    eager_a = pipe.run(*a)
    torch.cuda.synchronize()
    per_call = [c.count - x for c, x in zip(counters, before)]
    eager_b = pipe.run(*b)
    captures_before = pipe.graph_stats()["captures"]
    torch.cuda.synchronize()
    before = [c.count for c in counters]
    got = [pipe._jit(*a) for _ in range(GRAPH_REPLAYS)]
    torch.cuda.synchronize()
    replayed = [c.count - x for c, x in zip(counters, before)]
    got_b = pipe._jit(*b)
    check(pipe.graph_stats()["captures"] == captures_before,
          f"{label}: a request captured a graph after the first call")
    check(replayed == [GRAPH_REPLAYS * n for n in per_call],
          f"{label}: {GRAPH_REPLAYS} replays launched {replayed}, eager once {per_call}")
    for out in got:
        check(outputs_bitwise_equal(out, eager_a),
              f"{label}: the captured call differs from the eager body")
    check(outputs_bitwise_equal(got_b, eager_b),
          f"{label}: a replay on a second input did not give that input's result")
    check(not all(torch.equal(x, y) for x, y in zip(eager_a, eager_b)),
          f"{label}: the two inputs give the same result; the check shows nothing")
    return per_call, eager_a, eager_b


def run_graphs(card: str, dev: torch.device, counters) -> None:
    """Phases 22-23: each served path's CUDA graph against its eager body
    (``runtime/graphs``), then eager against captured through
    ``CUDAChannel`` on the same requests."""
    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.pipelines.detect3d import prepare_points

    def on_card_2d(batch):
        return (torch.from_numpy(batch).to(dev),)

    def on_card_3d(pc, pipe):
        padded, m = prepare_points(pc, pipe.model.cfg.voxel.point_features,
                                   pipe.config.point_buckets)
        return (torch.from_numpy(padded).to(dev), torch.tensor(m, dtype=torch.int32).to(dev))

    def request_3d(name, pc, pipe):
        padded, m = prepare_points(pc, pipe.model.cfg.voxel.point_features,
                                   pipe.config.point_buckets)
        return InferRequest(name, {"points": padded, "num_points": np.asarray(m, np.int32)})

    frames = SERVED["yolov5n"]["frames"]
    paths = []  # (label, model, route override, (input a, input b), requests a, b)
    for b in (1, B_MAIN):
        pair = (frames[:b], frames[B_MAIN + B_MAIN: B_MAIN + B_MAIN + b])
        # conf 0.05: 300 detections an image, so two inputs give two results;
        # the unfused route as deployed (the fixpoint, a loop the capture
        # cuts, runtime/graphs.fixed_point) and with kernel 2
        for model_name, route in (("yolov5n_c005", None), ("yolov5n_c005_unfused", None),
                                  ("yolov5n_c005_unfused", "pallas")):
            pipe = SERVED["yolov5n"]["pipes"][model_name][0]
            paths.append((f"{model_name}{'_pallas' if route else ''}_b{b}", "yolov5n", model_name,
                          route, tuple(on_card_2d(x) for x in pair),
                          tuple(InferRequest(model_name, {"images": x}) for x in pair)))
    for family in ("pointpillars", "second_iou"):
        served = SERVED[family]
        for model_name, (pipe, _, _) in served["pipes"].items():
            for n in SCAN_POINTS:
                pair = served["scans"][n][:2]
                paths.append((f"{model_name}_{n}", family, model_name, None,
                              tuple(on_card_3d(pc, pipe) for pc in pair),
                              tuple(request_3d(model_name, pc, pipe) for pc in pair)))

    # -- 22. the captured graph against the eager body ---------------------------
    rows = {}
    for label, family, model_name, route, (a, b), (req_a, req_b) in paths:
        served = SERVED[family]
        pipe = served["pipes"][model_name][0]
        if route:
            os.environ["TRITON_CLIENT_TPU_NMS"] = route
        try:
            # captured already at registration: the first call captures nothing
            captures = pipe.graph_stats()["captures"]
            per_call, eager_a, eager_b = hold_captured_to_eager(pipe, a, b, counters, label)
            check(pipe.graph_stats()["captures"] == captures,
                  f"{label}: a request captured a graph after the registration warmup")
            # two requests in flight at pipeline_depth 2, resolved in reverse
            channel = served["channel"]
            check(channel.pipeline_depth == 2, "the channel is not at pipeline_depth 2")
            fut_a = channel.do_inference_async(req_a)
            fut_b = channel.do_inference_async(req_b)
            out_b, out_a = fut_b.result().outputs, fut_a.result().outputs
            for out, eager, which in ((out_a, eager_a, "first"), (out_b, eager_b, "second")):
                for key, want in zip(("detections", "valid"), eager):
                    check(out[key].tobytes() == want.cpu().numpy().tobytes(),
                          f"{label}: the {which} of two requests in flight got other {key}")
        finally:
            os.environ.pop("TRITON_CLIENT_TPU_NMS", None)
        rows[label] = {"launches_per_call": {c_name: n for c_name, n in
                                             zip(COUNTER_NAMES, per_call) if n},
                       "replays": GRAPH_REPLAYS, "bitwise": True, "second_input": True,
                       "two_in_flight_reversed": True}
    models = {}
    for family in ("yolov5n", "pointpillars", "second_iou"):
        for model_name, (pipe, _, _) in SERVED[family]["pipes"].items():
            models[model_name] = pipe.graph_stats()
    emit("graphs", card, paths=rows, graphs_by_model=models,
         pool_bytes_total=sum(m["pool_bytes"] for m in models.values()),
         reserved_bytes=torch.cuda.memory_reserved(dev))

    # -- 23. eager against captured through the channel, same requests ----------
    times = {}
    for label, family, model_name, route, _, (req_a, req_b) in paths:
        served = SERVED[family]
        pipe, spec, _ = served["pipes"][model_name]
        eager_name = f"{model_name}_eager"
        try:
            served["repo"].get(eager_name)
        except KeyError:  # the eager body served as the model's infer_fn
            served["repo"].register(dataclasses.replace(spec, name=eager_name), pipe.device_fn())
        if route:
            os.environ["TRITON_CLIENT_TPU_NMS"] = route
        try:
            reps = GRAPH_REQUESTS_2D if family == "yolov5n" else GRAPH_REQUESTS_3D
            unit = "frames_per_s" if family == "yolov5n" else "scans_per_s"
            size = (lambda r: r.inputs["images"].shape[0]) if family == "yolov5n" else (lambda r: 1)
            row = {}
            for mode, name in (("eager", eager_name), ("captured", model_name), ("eager2", eager_name),
                               ("captured2", model_name)):
                reqs = [dataclasses.replace(r, model_name=name) for r in (req_a, req_b)]
                row[mode] = serve(served["channel"].do_inference, reqs, reps, unit, size)
            if label in ("yolov5n_c005_b1", f"pointpillars_{SCAN_POINTS[1]}"):
                for mode, name in (("eager", eager_name), ("captured", model_name)):
                    req = dataclasses.replace(req_a, model_name=name)
                    row[f"profile_{mode}"] = request_profile(
                        lambda: served["channel"].do_inference(req), PROFILE_REQUESTS)
        finally:
            os.environ.pop("TRITON_CLIENT_TPU_NMS", None)
        times[label] = row
    emit("times_graphs", card, requests_per_mode=[GRAPH_REQUESTS_2D, GRAPH_REQUESTS_3D],
         paths=times)


COUNTER_NAMES = ("decode_nms_2d", "greedy_nms", "residual_decode_3d", "suppress_pack_3d",
                 "segment_mean", "segment_sum", "residual_decode_3d_gathered")


def run_driver(card: str) -> None:
    """Phase 24: ``InferenceDriver`` over ``CUDAChannel`` on seeded 512^2
    frames (YOLOv5n) and seeded clouds (PointPillars): sync, ``--async``
    with 2 in flight, and batch 8 (2D)."""
    from triton_client_tpu_torch.drivers.driver import (
        InferenceDriver,
        channel_infer,
        channel_infer3d,
    )
    from triton_client_tpu_torch.io.sources import SyntheticImageSource, SyntheticPointCloudSource

    class Recording:
        def __init__(self):
            self.rows = {}

        def write(self, frame, result):
            self.rows[frame.frame_id] = {k: np.asarray(v) for k, v in result.items()}

        def close(self):
            pass

    def drive(infer, source, **kw):
        sink = Recording()
        stats = InferenceDriver(infer, source, sink=sink, warmup=1, **kw).run()
        return stats, sink.rows

    out = {}
    channel = SERVED["yolov5n"]["channel"]
    name = "yolov5n_c005"  # 300 detections an image
    source = SyntheticImageSource(DRIVER_FRAMES, (512, 512), seed=24)
    runs = {
        "sync": drive(channel_infer(channel, name), source),
        "async_inflight2": drive(channel_infer(channel, name, asynchronous=True), source,
                                 inflight=2),
        "batch8": drive(channel_infer(channel, name), source, batch_size=B_MAIN),
    }
    sync = runs["sync"][1]
    check(len(sync) == DRIVER_FRAMES, f"the sync run delivered {len(sync)} frames")
    for mode, (stats, rows) in runs.items():
        check(stats.frames == DRIVER_FRAMES and sorted(rows) == sorted(sync),
              f"{mode}: {stats.frames} frames, ids {sorted(rows)[:4]}...")
    for i, row in runs["async_inflight2"][1].items():
        for key in ("detections", "valid"):
            check(row[key].tobytes() == sync[i][key].tobytes(),
                  f"frame {i}: the async run's {key} differ from the sync run's")
    b8_err, live, other_keep = 0.0, 0, []
    for i, row in runs["batch8"][1].items():
        if not np.array_equal(row["valid"], sync[i]["valid"]):
            other_keep.append(i)
            continue
        rows_b8, rows_b1 = row["detections"][row["valid"]], sync[i]["detections"][sync[i]["valid"]]
        live += len(rows_b1)
        if len(rows_b1):
            b8_err = max(b8_err, float(np.abs(rows_b8 - rows_b1).max()))
    print(json.dumps({"batch8_vs_batch1": {"frames_keeping_other_rows": other_keep,
                                           "max_abs_err": b8_err, "live_rows": live}}), flush=True)
    check(not other_keep, f"frames {other_keep}: batch 8 keeps other rows than batch 1")
    check(b8_err <= 1e-5, f"batch 8 differs from batch 1 by {b8_err} on a live row")
    out[name] = {m: {**st.to_dict(), "detections": int(sum(r["valid"].sum() for r in rows.values()))}
                      for m, (st, rows) in runs.items()}
    out[name]["async_equals_sync_bitwise"] = True
    out[name]["batch8_vs_batch1_max_abs_err"] = b8_err
    out[name]["live_rows"] = live

    channel = SERVED["pointpillars"]["channel"]
    source = SyntheticPointCloudSource(DRIVER_CLOUDS, seed=24)
    runs = {
        "sync": drive(channel_infer3d(channel, "pointpillars"), source),
        "async_inflight2": drive(channel_infer3d(channel, "pointpillars", asynchronous=True),
                                 source, inflight=2),
    }
    sync = runs["sync"][1]
    check(len(sync) == DRIVER_CLOUDS, f"the sync run delivered {len(sync)} clouds")
    for i, row in runs["async_inflight2"][1].items():
        for key in ("pred_boxes", "pred_scores", "pred_labels"):
            check(row[key].tobytes() == sync[i][key].tobytes(),
                  f"cloud {i}: the async run's {key} differ from the sync run's")
    out["pointpillars"] = {m: {**st.to_dict(), "detections": int(sum(len(r["pred_scores"])
                                                                    for r in rows.values()))}
                           for m, (st, rows) in runs.items()}
    out["pointpillars"]["async_equals_sync_bitwise"] = True
    emit("driver", card, frames=DRIVER_FRAMES, frame_hw=[512, 512], clouds=DRIVER_CLOUDS, **out)


# phase 25: the disk repository's entries (configs only); the YOLOv5n entry
# is served twice, as it stands (conf 0.3) and at conf 0.05 (detections on
# random weights); requests a timed path, requests of the stream
FACADE_ENTRIES = ("yolov5_crop_base", "pointpillar_kitti", "second_iou")
FACADE_C005 = "yolov5_crop_base_c005"
FACADE_REQUESTS, FACADE_STREAM = 30, 8


def facade_repository(tmp: pathlib.Path) -> pathlib.Path:
    """A repository root holding copies of the three portable entries'
    ``config.yaml`` and the conf-0.05 YOLOv5n entry derived from one."""
    for name in FACADE_ENTRIES:
        (tmp / name).mkdir()
        (tmp / name / "config.yaml").write_bytes(
            (ROOT / "examples" / name / "config.yaml").read_bytes())
    text = (ROOT / "examples" / FACADE_ENTRIES[0] / "config.yaml").read_text()
    check("conf_thresh: 0.3" in text, "examples/yolov5_crop_base changed its conf_thresh")
    (tmp / FACADE_C005).mkdir()
    (tmp / FACADE_C005 / "config.yaml").write_text(
        text.replace("conf_thresh: 0.3", "conf_thresh: 0.05"))
    return tmp


def run_facade(card: str, counters) -> None:
    """Phase 25: the KServe v2 façade. ``scan_disk`` builds the disk
    repository (its YAML read by ``yaml_subset``), ``CUDAChannel`` serves it
    with each entry's graphs captured at registration, and the server's
    ``_Servicer`` answers every RPC in-process on request bytes
    (``channel/kserve/service.invoke``: the deserializer and serializer
    grpc would use, an ``InProcessContext``). Where ``grpc`` imports, the
    same checks run through ``InferenceServer`` on a loopback port and the
    port's ``GRPCChannel``."""
    import shutil
    import tempfile

    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.channel.kserve import codec, pb, service
    from triton_client_tpu_torch.obs.trace import Tracer
    from triton_client_tpu_torch.pipelines.detect3d import prepare_points
    from triton_client_tpu_torch.runtime.disk_repository import scan_disk
    from triton_client_tpu_torch.runtime.server import _Servicer

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="facade_repo_"))
    cwd = os.getcwd()
    os.chdir(ROOT)  # the entries name data/ files relative to the checkout
    try:
        t0 = time.perf_counter()
        repo = scan_disk(facade_repository(tmp))
        for name, _ in repo.list_models():
            repo.get(name).warmup()
        build_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp)
    channel = CUDAChannel(repo)
    tracer = Tracer(capacity=4 * FACADE_REQUESTS)
    servicer = _Servicer(repo, channel, stream_pipeline_depth=2, tracer=tracer)
    names = [n for n, _ in repo.list_models()]
    check(sorted(names) == sorted(FACADE_ENTRIES + (FACADE_C005,)), f"scanned {names}")
    for name in names:
        spec = repo.metadata(name)
        check("decode_nms" in spec.extra["fused_stages"], f"{name}: not fused on the card")

    def rpc(method, msg, context=None):
        return service.METHODS[method][1].FromString(
            service.invoke(servicer, method, msg.SerializeToString(), context))

    # -- health, metadata, config, index -----------------------------------------
    check(rpc("ServerLive", pb.ServerLiveRequest()).live, "ServerLive")
    check(rpc("ServerReady", pb.ServerReadyRequest()).ready, "ServerReady")
    meta = rpc("ServerMetadata", pb.ServerMetadataRequest())
    check(meta.name == "triton_client_tpu_torch" and "binary_tensor_data" in meta.extensions,
          "ServerMetadata")
    index = rpc("RepositoryIndex", pb.RepositoryIndexRequest())
    check(sorted((m.name, m.version, m.state) for m in index.models)
          == sorted((n, "1", "READY") for n in names), "RepositoryIndex")
    configs = {}
    for name in names:
        check(rpc("ModelReady", pb.ModelReadyRequest(name=name)).ready, f"ModelReady {name}")
        md = rpc("ModelMetadata", pb.ModelMetadataRequest(name=name))
        spec = repo.metadata(name)
        check([t.name for t in md.inputs] == [t.name for t in spec.inputs]
              and md.platform == "torch", f"ModelMetadata {name}")
        cfg = rpc("ModelConfig", pb.ModelConfigRequest(name=name)).config
        params = {k: json.loads(v) for k, v in cfg.parameters.items()}
        check(params == json.loads(json.dumps(spec.extra)), f"ModelConfig parameters {name}")
        configs[name] = {"max_batch_size": cfg.max_batch_size,
                         "inputs": [list(t.dims) for t in cfg.input]}
    check(not rpc("ModelReady", pb.ModelReadyRequest(name="nope")).ready, "ModelReady nope")

    # -- the requests ----------------------------------------------------------------
    rng = np.random.default_rng(25)
    hw = tuple(repo.metadata(FACADE_C005).extra["model_input_hw"])
    frames = rng.integers(0, 256, (B_MAIN + FACADE_STREAM + 1, *hw, 3)).astype(np.float32)
    requests = {  # label -> (model, inputs)
        "yolov5n_c005_b1": (FACADE_C005, {"images": frames[:1]}),
        f"yolov5n_c005_b{B_MAIN}": (FACADE_C005, {"images": frames[1:1 + B_MAIN]}),
        "yolov5n_conf0.3_b1": (FACADE_ENTRIES[0], {"images": frames[:1]}),
    }
    for model in FACADE_ENTRIES[1:]:
        pipe_cfg = repo.metadata(model).extra
        for i, n in enumerate(SCAN_POINTS):
            pc = uniform_clouds(250 + i, (0.0, -39.68, -3.0, 69.12, 39.68, 1.0), n, 1)[0]
            padded, m = prepare_points(pc, 4, pipe_cfg["point_buckets"], pipe_cfg["z_offset"])
            requests[f"{model}_{n}"] = (model, {"points": padded,
                                                "num_points": np.asarray(m, np.int32)})
    stream_frames = [frames[1 + B_MAIN + i: 2 + B_MAIN + i] for i in range(FACADE_STREAM)]

    def wire(model, inputs, rid=""):
        return codec.build_infer_request(model, inputs, request_id=rid).SerializeToString()

    def through_servicer(payload):
        return codec.parse_infer_response(pb.ModelInferResponse.FromString(
            service.invoke(servicer, "ModelInfer", payload)))

    # the direct channel's answers, and one uncounted pass through the
    # servicer (any capture happens here, outside the counted window)
    direct = {label: channel.do_inference(InferRequest(m, x)).outputs
              for label, (m, x) in requests.items()}
    direct_stream = [channel.do_inference(InferRequest(FACADE_C005, {"images": f})).outputs
                     for f in stream_frames]
    payloads = {label: wire(m, x, label) for label, (m, x) in requests.items()}
    for payload in payloads.values():
        through_servicer(payload)
    torch.cuda.synchronize()

    # -- the counted window: ModelInfer and ModelStreamInfer through the servicer -----
    for counter in counters:
        counter.reset()
    got = {label: through_servicer(p) for label, p in payloads.items()}
    stream_out = [pb.ModelStreamInferResponse.FromString(b) for b in service.invoke(
        servicer, "ModelStreamInfer",
        [wire(FACADE_C005, {"images": f}, f"s{i}") for i, f in enumerate(stream_frames)])]
    torch.cuda.synchronize()
    launches = dict(zip(COUNTER_NAMES, (c.count for c in counters)))
    fused_2d = 3 + FACADE_STREAM
    scans_3d = 2 * len(SCAN_POINTS)
    want_launches = {"decode_nms_2d": fused_2d, "greedy_nms": 0,
                     "residual_decode_3d": scans_3d, "suppress_pack_3d": scans_3d,
                     "segment_mean": len(SCAN_POINTS), "segment_sum": 0,
                     "residual_decode_3d_gathered": scans_3d}
    check(launches == want_launches, f"façade launches {launches}, want {want_launches}")

    for label, out in got.items():
        want = direct[label]
        check(sorted(out) == sorted(want), f"{label}: outputs {sorted(out)}")
        for key in want:
            check(out[key].dtype == want[key].dtype and out[key].shape == want[key].shape
                  and out[key].tobytes() == want[key].tobytes(),
                  f"{label}: {key} through the servicer differs from CUDAChannel.do_inference")
        check(bool(np.isfinite(out["detections"]).all()), f"{label}: non-finite detections")
    kept = {label: int(out["valid"].sum()) for label, out in got.items()}
    check(kept["yolov5n_c005_b1"] > 0 and kept[f"yolov5n_c005_b{B_MAIN}"] > 0,
          f"conf 0.05 kept nothing: {kept}")
    check(all(v > 0 for k, v in kept.items() if not k.startswith("yolov5n")), f"3D kept {kept}")
    check(len(stream_out) == FACADE_STREAM, f"{len(stream_out)} stream responses")
    for i, (resp, want) in enumerate(zip(stream_out, direct_stream)):
        check(not resp.error_message, f"stream {i}: {resp.error_message}")
        check(resp.infer_response.id == f"s{i}", f"stream response {i} is {resp.infer_response.id}")
        out = codec.parse_infer_response(resp.infer_response)
        check(all(out[k].tobytes() == want[k].tobytes() for k in want),
              f"stream response {i} is not its request's result")
    check(any(stream_out[0].infer_response.raw_output_contents[0] != r.infer_response
              .raw_output_contents[0] for r in stream_out[1:]),
          "the stream's requests all give one result; the order check shows nothing")

    # -- errors ------------------------------------------------------------------------
    codes = {}
    for label, payload in (
        ("unknown_model", wire("nope", {"images": frames[:1]})),
        ("wrong_shape", wire(FACADE_C005, {"images": frames[:1, :, :, :2]})),
    ):
        ctx = service.InProcessContext()
        try:
            service.invoke(servicer, "ModelInfer", payload, ctx)
        except service.RpcAborted:
            pass
        codes[label] = ctx.aborted[0] if ctx.aborted else "OK"
    check(codes == {"unknown_model": "NOT_FOUND", "wrong_shape": "INVALID_ARGUMENT"},
          f"status codes {codes}")

    # -- times: servicer against the direct channel, on the same requests ------------
    times = {}
    for label, unit, size in (("yolov5n_c005_b1", "frames_per_s", lambda r: 1),
                              (f"pointpillar_kitti_{SCAN_POINTS[1]}", "scans_per_s",
                               lambda r: 1)):
        model, inputs = requests[label]
        req = InferRequest(model, inputs)
        payload = payloads[label]
        row = {}
        for mode in ("direct", "servicer", "direct2", "servicer2"):
            call = (lambda _x: channel.do_inference(req)) if mode.startswith("direct") else (
                lambda _x: service.invoke(servicer, "ModelInfer", payload))
            row[mode] = serve(call, [None], FACADE_REQUESTS, unit, size)
        times[label] = row
    # the servicer's own host time a request: the message decode, its spans
    # outside the channel (admission, parse, encode, the span summary, the
    # accounting), the response encode
    host = {}
    for label in times:
        payload = payloads[label]
        t = time.perf_counter()
        for _ in range(FACADE_REQUESTS):
            pb.ModelInferRequest.FromString(payload)
        decode_ms = (time.perf_counter() - t) / FACADE_REQUESTS * 1e3
        resp = pb.ModelInferResponse.FromString(service.invoke(servicer, "ModelInfer", payload))
        t = time.perf_counter()
        for _ in range(FACADE_REQUESTS):
            resp.SerializeToString()
        serialize_ms = (time.perf_counter() - t) / FACADE_REQUESTS * 1e3
        traces = [tr for tr in tracer.recent() if tr.request_id == label][-FACADE_REQUESTS:]
        inside, channel_ms, spans = [], [], {}
        for tr in traces:
            ch = sum(s.duration_s for s in tr.spans if s.name == "channel")
            inside.append((tr.wall_s() - ch) * 1e3)
            channel_ms.append(ch * 1e3)
            for s in tr.spans:
                if s.name in ("parse", "encode"):
                    spans.setdefault(s.name, []).append(s.duration_s * 1e3)
        check(len(traces) >= FACADE_REQUESTS // 2, f"{label}: {len(traces)} traces kept")
        host[label] = {"decode_message_ms": decode_ms, "serialize_response_ms": serialize_ms,
                       "outside_channel_ms_p50": float(np.median(inside)),
                       "channel_ms_p50": float(np.median(channel_ms)),
                       **{f"{k}_ms_p50": float(np.median(v)) for k, v in spans.items()},
                       "servicer_host_ms": decode_ms + serialize_ms + float(np.median(inside)),
                       "request_bytes": len(payload),
                       "response_bytes": len(resp.SerializeToString())}

    # -- the socket leg ------------------------------------------------------------------
    try:
        import grpc  # noqa: F401
        grpc_ok = True
    except ImportError:
        grpc_ok = False
    socket_leg = None
    if grpc_ok:
        from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel
        from triton_client_tpu_torch.runtime.server import InferenceServer

        server = InferenceServer(repo, channel, address="127.0.0.1:0", max_workers=4)
        server.start()
        try:
            client = GRPCChannel(f"127.0.0.1:{server.port}", timeout_s=120,
                                 use_shared_memory=False)  # the wire leg; shm is phase 27
            check(client.server_live() and client.server_ready(), "grpc: not live")
            for label, (m, x) in requests.items():
                out = client.do_inference(InferRequest(m, x)).outputs
                check(all(out[k].tobytes() == direct[label][k].tobytes() for k in direct[label]),
                      f"grpc {label}: differs from CUDAChannel.do_inference")
            socket_leg = {"requests_checked": len(requests)}
            for label in times:  # the timed paths, through the socket
                model, inputs = requests[label]
                req = InferRequest(model, inputs)
                socket_leg[label] = serve(lambda _x: client.do_inference(req), [None],
                                          FACADE_REQUESTS, "frames_per_s"
                                          if label.startswith("yolov5n") else "scans_per_s")
            client.close()
        finally:
            server.stop()
    SERVED["socket_leg"] = socket_leg  # phase 27 prints it beside its clients
    emit("facade", card, build_and_capture_s=build_s, entries=names, model_configs=configs,
         requests=sorted(requests), stream=FACADE_STREAM, bitwise_equal_to_channel=True,
         kept=kept, launches=launches, status_codes=codes, times=times, servicer_host=host,
         grpc=grpc_ok, socket_leg=socket_leg)


# phase 26: the layout and precision of examples/yolov5_crop. The entries
# as they stand (conf 0.3) and at conf 0.05, each holding one seeded
# upstream checkpoint of its variant (1/weights.pt; the conf-0.05 copies
# also 2/weights.onnx of the same tensors); PointPillars and SECOND-IoU
# with 1/weights.pth; yolov5_crop_base under precision="bf16"
LAYOUT_ENTRIES = ("yolov5_crop_base", "yolov5_crop", "yolov5_crop_mxu", "yolov5l_crop")
LAYOUT_3D = ("pointpillar_kitti", "second_iou")
LAYOUT_REQUESTS, LAYOUT_MAP_FRAMES = 20, 8



def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b, v = v & 0x7F, v >> 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _ld(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def onnx_bytes(state: dict) -> bytes:
    """A ModelProto holding ``state`` as its graph's float32 initializers
    (the weights of a ``torch.onnx`` export; no graph nodes)."""
    tensors = []
    for name, t in state.items():
        arr = t.detach().float().cpu().numpy()
        body = b"".join(_varint(1 << 3) + _varint(d) for d in arr.shape)
        body += _varint(2 << 3) + _varint(1) + _ld(8, name.encode()) + _ld(9, arr.tobytes())
        tensors.append(_ld(5, body))
    return _ld(7, b"".join(tensors))


def upstream_yolov5(variant: str, seed: int) -> dict:
    """A seeded ultralytics-named YOLOv5 checkpoint (``model.N.*``) of the
    plain layout, drawn as flax initialises the JAX models (the statistics
    of tests/test_precision.py's budget check: BatchNorm the identity,
    biases 0)."""
    from triton_client_tpu_torch.models.layers import init_random_
    from triton_client_tpu_torch.models.yolov5 import YoloV5
    from triton_client_tpu_torch.runtime.importers import yolov5_torch_key

    model = init_random_(YoloV5(num_classes=NC, variant=variant), seed)
    return {yolov5_torch_key(k): v for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def layout_repository(tmp: pathlib.Path) -> tuple[pathlib.Path, dict]:
    """The phase-26 repository root, and each variant's checkpoint."""
    from triton_client_tpu_torch.runtime import importers
    from triton_client_tpu_torch.runtime.disk_repository import _Entry

    weights = {"n": upstream_yolov5("n", 26), "l": upstream_yolov5("l", 26)}
    for name in LAYOUT_ENTRIES:
        text = (ROOT / "examples" / name / "config.yaml").read_text()
        check("conf_thresh: 0.3" in text, f"examples/{name} changed its conf_thresh")
        state = weights["l" if "variant: l" in text else "n"]
        for entry, body, versions in ((name, text, ("1",)),
                                      (f"{name}_c005", text.replace("conf_thresh: 0.3",
                                                                    "conf_thresh: 0.05"),
                                       ("1", "2"))):
            (tmp / entry / "1").mkdir(parents=True)
            (tmp / entry / "config.yaml").write_text(body)
            torch.save({"model": state}, tmp / entry / "1" / "weights.pt")
            if "2" in versions:
                (tmp / entry / "2").mkdir()
                (tmp / entry / "2" / "weights.onnx").write_bytes(onnx_bytes(state))
    keys = {"pointpillar_kitti": importers.pointpillars_torch_key,
            "second_iou": importers.second_torch_key}
    for name in LAYOUT_3D:
        (tmp / name / "1").mkdir(parents=True)
        (tmp / name / "config.yaml").write_bytes(
            (ROOT / "examples" / name / "config.yaml").read_bytes())
        _, _, model = _Entry(tmp / name, device="cpu")._build()  # seeded, on the host
        state = {keys[name](k): v for k, v in model.state_dict().items()
                 if not k.endswith("num_batches_tracked")}
        torch.save({"model_state": state}, tmp / name / "1" / "weights.pth")
    return tmp, weights


def run_layout(card: str, counters) -> None:
    """Phase 26: the layout and precision of ``examples/yolov5_crop``. The
    s2d/ch_floor/bf16 entries (YOLOv5n twice, YOLOv5l at full width) built
    by ``scan_disk`` from upstream checkpoints in their version dirs
    (``weights.pt``, ``weights.onnx``; the 3D entries ``weights.pth``),
    served by ``CUDAChannel`` and the KServe v2 servicer; the bf16 policy as
    a repository-wide override; bf16 against f32 by the port's
    ``eval/detection_map``."""
    import shutil
    import tempfile

    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.channel.kserve import codec, pb, service
    from triton_client_tpu_torch.config import BF16
    from triton_client_tpu_torch.eval.detection_map import DetectionEvaluator
    from triton_client_tpu_torch.pipelines.detect2d import Detect2DConfig, build_yolov5_pipeline
    from triton_client_tpu_torch.pipelines.detect3d import prepare_points
    from triton_client_tpu_torch.runtime import importers
    from triton_client_tpu_torch.runtime.disk_repository import load_pipeline, scan_disk
    from triton_client_tpu_torch.channel.staged import cast_wire_input
    from triton_client_tpu_torch.runtime.precision import MAP_BUDGETS, to_bf16_words
    from triton_client_tpu_torch.runtime.server import _Servicer

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="layout_repo_"))
    cwd = os.getcwd()
    os.chdir(ROOT)  # the entries name data/ files relative to the checkout
    try:
        t0 = time.perf_counter()
        root, weights = layout_repository(tmp)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        repo = scan_disk(root)
        for name, version in repo.list_models():
            repo.get(name, version).warmup()
        build_s = time.perf_counter() - t0
        c005 = [f"{n}_c005" for n in LAYOUT_ENTRIES]
        in_process = {name: load_pipeline(root / name, version="1")[0] for name in c005}
        in_process_3d = {name: load_pipeline(root / name)[0] for name in LAYOUT_3D}
        override_root = _only(root, LAYOUT_ENTRIES[0], tmp / "override")
        _only(root, c005[0], override_root)
        override = scan_disk(override_root, precision="bf16")
    finally:
        os.chdir(cwd)
    channel = CUDAChannel(repo)
    servicer = _Servicer(repo, channel, stream_pipeline_depth=2)
    names = sorted(repo.names())
    check(names == sorted(LAYOUT_ENTRIES + tuple(c005) + LAYOUT_3D), f"scanned {names}")
    for name in names:
        spec = repo.metadata(name)
        check("decode_nms" in spec.extra["fused_stages"], f"{name}: not fused on the card")
        want = "2" if name in c005 else "1"
        check(repo.versions(name)[-1] == want, f"{name}: versions {repo.versions(name)}")

    # -- requests: every 2D entry and version at batch 1 and 8, one 20k scan a 3D entry ----
    rng = np.random.default_rng(26)
    hw = tuple(repo.metadata(c005[0]).extra["model_input_hw"])
    frames = rng.integers(0, 256, (B_MAIN + 1, *hw, 3)).astype(np.float32)
    requests = {}  # label -> (model, version, inputs)
    for name in LAYOUT_ENTRIES + tuple(c005):
        for version in repo.versions(name):
            requests[f"{name}:{version}_b1"] = (name, version, {"images": frames[:1]})
            requests[f"{name}:{version}_b{B_MAIN}"] = (name, version,
                                                      {"images": frames[1:1 + B_MAIN]})
    for i, name in enumerate(LAYOUT_3D):
        pipe_cfg = repo.metadata(name).extra
        pc = uniform_clouds(260 + i, (0.0, -39.68, -3.0, 69.12, 39.68, 1.0), SCAN_POINTS[0], 1)[0]
        padded, m = prepare_points(pc, 4, pipe_cfg["point_buckets"], pipe_cfg["z_offset"])
        requests[name] = (name, "1", {"points": padded, "num_points": np.asarray(m, np.int32)})

    def through_servicer(model, version, inputs):
        payload = codec.build_infer_request(model, inputs, model_version=version)
        return codec.parse_infer_response(pb.ModelInferResponse.FromString(
            service.invoke(servicer, "ModelInfer", payload.SerializeToString())))

    direct = {label: channel.do_inference(InferRequest(m, x, model_version=v)).outputs
              for label, (m, v, x) in requests.items()}
    for m, v, x in requests.values():  # any capture happens here, outside the window
        through_servicer(m, v, x)
    torch.cuda.synchronize()
    captures = {(n, v): repo.get(n, v).infer_fn.graph_stats()["captures"]
                for n in names for v in repo.versions(n)}

    # -- the counted window -------------------------------------------------------------------
    for counter in counters:
        counter.reset()
    got = {label: through_servicer(m, v, x) for label, (m, v, x) in requests.items()}
    torch.cuda.synchronize()
    launches = dict(zip(COUNTER_NAMES, (c.count for c in counters)))
    n2d = len(requests) - len(LAYOUT_3D)
    want_launches = {"decode_nms_2d": n2d, "greedy_nms": 0, "residual_decode_3d": 2,
                     "suppress_pack_3d": 2, "segment_mean": 1, "segment_sum": 0,
                     "residual_decode_3d_gathered": 2}
    check(launches == want_launches, f"layout launches {launches}, want {want_launches}")
    after = {(n, v): repo.get(n, v).infer_fn.graph_stats()["captures"]
             for n in names for v in repo.versions(n)}
    check(after == captures, "a request captured a graph inside the counted window")

    for label, out in got.items():
        want = direct[label]
        for key in want:
            check(out[key].dtype == want[key].dtype and out[key].tobytes() == want[key].tobytes(),
                  f"{label}: {key} through the servicer differs from CUDAChannel.do_inference")
        check(out["detections"].dtype == np.float32 and bool(np.isfinite(out["detections"]).all()),
              f"{label}: detections not finite float32")
    kept = {label: int(out["valid"].sum()) for label, out in got.items()}
    check(all(kept[f"{n}:{v}_b1"] > 0 for n in c005 for v in ("1", "2")),
          f"conf 0.05 kept nothing: {kept}")
    check(all(kept[n] > 0 for n in LAYOUT_3D), f"3D kept {kept}")

    # -- importers: .pt == .onnx == the in-process load_pipeline, captured == eager -------------
    eager_equal = {}
    for name in c005:
        pipe = in_process[name]
        for b, x in ((1, frames[:1]), (B_MAIN, frames[1:1 + B_MAIN])):
            xs = torch.from_numpy(x).cuda()
            captured = pipe.infer_fn()({"images": xs})
            eager = pipe.device_fn()({"images": xs})
            for key in ("detections", "valid"):
                pt, ox = (direct[f"{name}:{v}_b{b}"][key] for v in ("1", "2"))
                check(pt.tobytes() == ox.tobytes(), f"{name} b{b}: weights.pt != weights.onnx")
                check(captured[key].cpu().numpy().tobytes() == pt.tobytes(),
                      f"{name} b{b}: served != load_pipeline in-process")
                check(torch.equal(captured[key], eager[key]),
                      f"{name} b{b}: captured != eager")
            eager_equal[f"{name}_b{b}"] = True
    for name in LAYOUT_3D:
        _, _, x = requests[name]
        out = in_process_3d[name].infer_fn()({k: torch.from_numpy(np.asarray(v)).cuda()
                                              for k, v in x.items()})
        check(all(out[k].cpu().numpy().tobytes() == direct[name][k].tobytes() for k in out),
              f"{name}: weights.pth served != load_pipeline in-process")

    # -- the precision override ----------------------------------------------------------------
    base = override.get(LAYOUT_ENTRIES[0])
    check(base.precision.name == "bf16" and base.spec.extra["precision"] == "bf16",
          "precision='bf16' did not reach the entry")
    base.warmup()
    ochannel = CUDAChannel(override)
    words = cast_wire_input(base, "images", frames[:1])
    check(words.dtype == BF16, f"the bf16 policy staged {words.dtype}")
    staged, slot = ochannel._upload({"images": words})
    check(staged["images"].dtype == torch.bfloat16 and staged["images"].is_cuda,
          f"staged {staged['images'].dtype}")
    if slot is not None:
        ochannel._give_slot(slot)
    keys_before = base.infer_fn.graph_stats()
    bout = ochannel.do_inference(InferRequest(LAYOUT_ENTRIES[0], {"images": frames[:1]})).outputs
    check(base.infer_fn.graph_stats()["captures"] == keys_before["captures"],
          "a bf16-staged request captured: the warmup was not at the wire dtype")
    check(bout["detections"].dtype == np.float32, "bf16 policy: detections not float32")
    # batch 8 captures here, before it is timed
    ochannel.do_inference(InferRequest(LAYOUT_ENTRIES[0], {"images": frames[1:1 + B_MAIN]}))
    downcast_ms = {}
    for b, x in ((1, frames[:1]), (B_MAIN, frames[1:1 + B_MAIN])):
        lat = []
        for _ in range(LAYOUT_REQUESTS):
            t = time.perf_counter()
            to_bf16_words(x)
            lat.append(time.perf_counter() - t)
        downcast_ms[f"b{b}"] = float(np.median(lat)) * 1e3

    def map_score(dets, valid, gts) -> float:
        ev = DetectionEvaluator()
        for a, b, gt in zip(dets, valid, gts):
            ev.add_frame(a, b, gt)
        return float(ev.summary()["map"])

    # the override's detections scored against the f32 entry's on the same
    # frames and weights: at conf 0.3 seeded weights keep nothing in either,
    # so the conf-0.05 copy of the entry is the one scored
    f32_outs, bf16_outs = [], []
    for x in (frames[:1], frames[1:1 + B_MAIN]):
        f32_outs.append(direct[f"{c005[0]}:1_b{len(x)}"])
        out = ochannel.do_inference(InferRequest(c005[0], {"images": x}, model_version="1")).outputs
        check(out["detections"].dtype == np.float32 and bool(np.isfinite(out["detections"]).all()),
              f"bf16 policy b{len(x)}: detections not finite float32")
        bf16_outs.append(out)
    f32_dets, f32_valid, bf16_dets, bf16_valid = (
        np.concatenate([o[k] for o in outs]) for outs in (f32_outs, bf16_outs)
        for k in ("detections", "valid"))
    gts = [d[v][:, [0, 1, 2, 3, 5]] for d, v in zip(f32_dets, f32_valid)]
    override_map = {"f32": map_score(f32_dets, f32_valid, gts),
                    "bf16": map_score(bf16_dets, bf16_valid, gts),
                    "kept_f32": int(f32_valid.sum()), "kept_bf16": int(bf16_valid.sum())}
    override_map["floor"] = override_map["f32"] - MAP_BUDGETS["bf16"]
    check(override_map["kept_f32"] > 0 and override_map["bf16"] >= override_map["floor"],
          f"precision='bf16' {c005[0]}: {override_map}")

    # -- bf16 against f32 on the card, the port's detection_map ---------------------------------
    map_frames = rng.integers(0, 256, (LAYOUT_MAP_FRAMES, *hw, 3)).astype(np.float32)
    accuracy = {}
    for variant, state in weights.items():
        cfg = Detect2DConfig(model_name=f"yolov5{variant}", num_classes=NC, input_hw=hw,
                             conf_thresh=0.05)
        kw = dict(variant=variant, num_classes=NC, input_hw=hw, config=cfg,
                  state_dict=lambda model, s=state: importers.load_yolov5(s, model))
        plain, _, plain_model = build_yolov5_pipeline(**kw)
        mxu32, _, mxu_model = build_yolov5_pipeline(s2d=True, ch_floor=32, **kw)
        mxu16, spec16, _ = build_yolov5_pipeline(s2d=True, ch_floor=32, dtype="bf16", **kw)
        x = torch.from_numpy(map_frames[:2] / 255.0).float().cuda()
        with torch.no_grad():
            heads_err = max(float((a - b).abs().max()) for a, b in zip(plain_model(x),
                                                                      mxu_model(x)))
        check(heads_err <= 5e-4, f"yolov5{variant}: s2d/ch_floor f32 heads {heads_err} from plain")
        dets, valid = plain.infer(map_frames)
        gts = [d[v][:, [0, 1, 2, 3, 5]] for d, v in zip(dets, valid)]
        scores = {label: map_score(*out, gts)
                  for label, out in (("f32_plain", (dets, valid)),
                                     ("f32_s2d_ch_floor", mxu32.infer(map_frames)),
                                     ("bf16_s2d_ch_floor", mxu16.infer(map_frames)))}
        floor = scores["f32_plain"] - MAP_BUDGETS["bf16"]
        check(scores["bf16_s2d_ch_floor"] >= floor,
              f"yolov5{variant}: bf16 mAP {scores['bf16_s2d_ch_floor']} under {floor}")
        accuracy[f"yolov5{variant}"] = {"map": scores, "floor": floor, "heads_max_abs": heads_err,
                                        "kept_f32": int(valid.sum()),
                                        "param_bytes_bf16": spec16.extra["param_bytes"]}
        del plain, mxu32, mxu16, plain_model, mxu_model
    torch.cuda.empty_cache()

    # -- times: p50 and frames/s a conf-0.05 entry, at batch 1 and 8 ----------------------------
    times = {}
    for name in c005:
        for b, x in ((1, frames[:1]), (B_MAIN, frames[1:1 + B_MAIN])):
            req = InferRequest(name, {"images": x})
            times[f"{name}_b{b}"] = serve(lambda _x: channel.do_inference(req), [None],
                                          LAYOUT_REQUESTS, "frames_per_s", lambda _x: b)
    for b, x in ((1, frames[:1]), (B_MAIN, frames[1:1 + B_MAIN])):
        req = InferRequest(LAYOUT_ENTRIES[0], {"images": x})
        times[f"{LAYOUT_ENTRIES[0]}_precision_bf16_b{b}"] = serve(
            lambda _x: ochannel.do_inference(req), [None], LAYOUT_REQUESTS, "frames_per_s",
            lambda _x: b)
    shutil.rmtree(tmp)
    emit("layout", card, write_s=write_s, build_and_capture_s=build_s, entries=names,
         requests=len(requests), launches=launches, kept=kept,
         bitwise_servicer_channel=True, bitwise_pt_onnx_in_process=True,
         captured_equals_eager=eager_equal, precision_override={
             "staged": str(staged["images"].dtype), "detections": str(bout["detections"].dtype),
             "map_against_f32": override_map},
         downcast_host_ms=downcast_ms, accuracy=accuracy, times=times,
         param_bytes={n: repo.metadata(n).extra["param_bytes"] for n in names}
         | {f"{LAYOUT_ENTRIES[0]}_precision_bf16": base.spec.extra["param_bytes"]},
         graph_pool_bytes={f"{n}:{v}": repo.get(n, v).infer_fn.graph_stats()["pool_bytes"]
                           for n in names for v in repo.versions(n)})


# phase 27: the reference's own shape of run, a client process sending
# frames to serve. The entries: examples/yolov5_crop as it stands and at
# conf 0.05, and examples/pointpillar_kitti, each with seeded upstream
# weights in 1/ (phase 26's checkpoints)
REMOTE_2D, REMOTE_3D = "yolov5_crop", "pointpillar_kitti"
REMOTE_FRAMES, REMOTE_CLOUDS, REMOTE_SPLIT = 64, 16, 30
REMOTE_TRANSPORTS = ("wire", "shm", "uds")
REMOTE_2D_RUNS = {"b1": [], f"b{B_MAIN}": ["-b", str(B_MAIN)],
                  "async2": ["--async", "--inflight", "2"]}


def remote_repository(tmp: pathlib.Path) -> tuple[pathlib.Path, pathlib.Path]:
    """The phase-27 repository root and a directory of seeded 120k-point
    ``.npy`` clouds."""
    from triton_client_tpu_torch.runtime import importers
    from triton_client_tpu_torch.runtime.disk_repository import _Entry

    root = tmp / "repo"
    state = upstream_yolov5("n", 27)
    text = (ROOT / "examples" / REMOTE_2D / "config.yaml").read_text()
    check("conf_thresh: 0.3" in text and "dtype: bf16" in text and "s2d: true" in text,
          f"examples/{REMOTE_2D} changed")
    for entry, body in ((REMOTE_2D, text),
                        (f"{REMOTE_2D}_c005", text.replace("conf_thresh: 0.3",
                                                           "conf_thresh: 0.05"))):
        (root / entry / "1").mkdir(parents=True)
        (root / entry / "config.yaml").write_text(body)
        torch.save({"model": state}, root / entry / "1" / "weights.pt")
    (root / REMOTE_3D / "1").mkdir(parents=True)
    (root / REMOTE_3D / "config.yaml").write_bytes(
        (ROOT / "examples" / REMOTE_3D / "config.yaml").read_bytes())
    _, _, model = _Entry(root / REMOTE_3D, device="cpu")._build()  # seeded, on the host
    torch.save({"model_state": {importers.pointpillars_torch_key(k): v
                                for k, v in model.state_dict().items()
                                if not k.endswith("num_batches_tracked")}},
               root / REMOTE_3D / "1" / "weights.pth")
    clouds = tmp / "clouds"
    clouds.mkdir()
    pc_range = (0.0, -39.68, -3.0, 69.12, 39.68, 1.0)
    for i, pc in enumerate(uniform_clouds(27, pc_range, SCAN_POINTS[1], REMOTE_CLOUDS)):
        np.save(clouds / f"{i:03d}.npy", pc)
    return root, clouds


def client_run(cli: str, argv: list[str], out: pathlib.Path, remote: bool) -> tuple[dict, list]:
    """One ``python -m triton_client_tpu_torch <cli>`` process with a jsonl
    sink: (its report, its rows without their wall-clock ``ts``). A remote
    client runs with no card visible: it must do no device work."""
    env = dict(os.environ)
    if remote:
        env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-m", "triton_client_tpu_torch", cli, *argv, "--sink", "jsonl",
         "-o", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    check(proc.returncode == 0, f"{cli} {' '.join(argv)} exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    rows = [{k: v for k, v in json.loads(line).items() if k != "ts"}
            for line in open(out / "detections.jsonl")]
    return report, rows


def wire_split(client, request, reps: int) -> dict:
    """The loopback p50 split on the client's clock: traced
    ``client.do_inference`` calls, one at a time, whose traces carry the
    channel's own ``encode`` and ``decode`` spans and the server's span
    summary grafted between them (``obs/trace.graft_span_summary``, as
    the JAX router grafts a replica's). ``wire`` is the RPC's time beyond
    the server's wall: the graft splits it evenly into ``wire_send`` and
    ``wire_recv``, so it is reported as one number. Medians in ms."""
    import dataclasses

    from triton_client_tpu_torch.obs.trace import Tracer

    tracer = Tracer(capacity=reps)
    rows = {k: [] for k in ("client_encode", "wire", "server_wall", "client_decode", "total")}
    for _ in range(3):  # the output arena's sizes are learned on the first
        client.do_inference(request)
    for i in range(reps):
        trace = tracer.start(model=request.model_name, request_id=f"split{i}")
        t0 = time.perf_counter()
        client.do_inference(dataclasses.replace(request, trace=trace))
        t1 = time.perf_counter()
        tracer.finish(trace)
        spans = {sp.name: sp for sp in trace.spans}
        check({"encode", "wire_send", "wire_recv", "decode"} <= set(spans),
              f"a traced request carried spans {sorted(spans)}")
        for key, value in (
            ("client_encode", spans["encode"].duration_s),
            ("wire", spans["wire_send"].duration_s + spans["wire_recv"].duration_s),
            ("server_wall", spans["wire_recv"].t0 - spans["wire_send"].t1),
            ("client_decode", spans["decode"].duration_s),
            ("total", t1 - t0),
        ):
            rows[key].append(value)
    return {f"{k}_ms": float(np.median(v)) * 1e3 for k, v in rows.items()}


# a client process running split_legs: argv is the checkout, the legs as
# JSON, the 2D model and the clouds' directory
SPLIT_CHILD = ("import json, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke as cs; "
               "print(json.dumps(cs.split_legs(json.loads(sys.argv[2]), sys.argv[3], "
               "sys.argv[4])))")


def split_legs(legs: dict, model_2d: str, clouds: str) -> dict:
    """``wire_split`` of YOLOv5 batch 1 (an FP32 512² frame) and one
    PointPillars 120k scan (``000.npy``, padded by the served metadata) on
    each leg: name -> (endpoint, use_shared_memory)."""
    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel
    from triton_client_tpu_torch.pipelines.detect3d import prepare_points

    frame = np.random.default_rng(27).integers(0, 256, (1, 512, 512, 3)).astype(np.float32)
    cloud = np.load(pathlib.Path(clouds) / "000.npy")
    out = {}
    for transport, (endpoint, shm) in legs.items():
        client = GRPCChannel(endpoint, use_shared_memory=shm, timeout_s=120)
        extra = client.get_metadata(REMOTE_3D).extra
        padded, m = prepare_points(cloud, 4, extra["point_buckets"], extra["z_offset"])
        requests = {
            "yolov5_b1": InferRequest(model_2d, {"images": frame}),
            f"pointpillars_{SCAN_POINTS[1]}": InferRequest(
                REMOTE_3D, {"points": padded, "num_points": np.asarray(m, np.int32)}),
        }
        for label, req in requests.items():
            out[f"{label}_{transport}"] = wire_split(client, req, REMOTE_SPLIT)
        client.close()
    return out


def dequant_host() -> dict:
    """The servicer's q8/q16 decode (``runtime/wire_encoding.dequantize``,
    on the host, where the JAX server dequantizes on its device): a batch
    of eight FP32 512² frames as q8 and a 120k cloud padded to 131,072
    points as q16, each checked against the whole-tensor float64 formula
    and timed over 10 calls (median ms)."""
    from triton_client_tpu_torch.runtime import wire_encoding

    rng = np.random.default_rng(27)
    out = {}
    for label, arr, bits in (
        (f"frames_b{B_MAIN}_512_q8", rng.integers(0, 256, (B_MAIN, 512, 512, 3))
         .astype(np.float32), 8),
        ("cloud_131072_q16", rng.standard_normal((131072, 4)).astype(np.float32) * 20, 16),
    ):
        q, params = wire_encoding.quantize(arr, bits)
        scale, lo = float(params["q_scale"]), float(params["q_min"])
        got = wire_encoding.dequantize(q, scale, lo, np.float32)
        want = (q.astype(np.float64) * np.float64(np.float32(scale))
                + np.float64(np.float32(lo))).astype(np.float32)
        check(got.tobytes() == want.tobytes(), f"{label}: blocked dequantization differs")
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            wire_encoding.dequantize(q, scale, lo, np.float32)
            times.append(time.perf_counter() - t0)
        out[label] = {"payload_bytes": q.nbytes, "decoded_bytes": got.nbytes,
                      "host_ms_p50": float(np.median(times)) * 1e3}
    return out


def run_remote(card: str, counters) -> None:
    """Phase 27: ``detect2d``/``detect3d -u grpc:`` client processes against
    ``serve`` (``cli/serve.build_server`` in this process, so the kernel
    counters are read here), over the wire (``--no-shm``), shared memory
    (``--shm``) and the unix socket (``grpc:unix:``, auto -> shm). Each
    client's rows equal, bit for bit, the other transports' and the
    in-process ``-r`` run's on the same frames and weights; each report
    names its transport; the server launches kernel 1 once a 2D request
    and kernels 3 and 4 once a 3D request, with no capture inside the
    counted window. Then the wire split of YOLOv5 batch 1 and PointPillars
    120k on each transport, from this process and from a client process."""
    import shutil
    import tempfile

    from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel
    from triton_client_tpu_torch.channel.kserve import pb
    from triton_client_tpu_torch.cli import serve as serve_cli

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="remote_repo_"))
    cwd = os.getcwd()
    os.chdir(ROOT)  # the entries name data/ files relative to the checkout
    try:
        t0 = time.perf_counter()
        root, clouds = remote_repository(tmp)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        args = serve_cli.parser().parse_args(["-r", str(root), "-a", "127.0.0.1:0", "--uds",
                                              "auto", "--warmup", "--max-workers", "8"])
        server = serve_cli.build_server(args)
    finally:
        os.chdir(cwd)
    repo = server.servicer._repo
    model_2d = f"{REMOTE_2D}_c005"
    # the rest of the registration warmup: the clients' uint8 512x512 frames
    # at batch 1 and 8 (the entry's own warmup captures float32 batch 1)
    for b in (1, B_MAIN):
        repo.get(model_2d).infer_fn({"images": torch.zeros((b, 512, 512, 3), dtype=torch.uint8,
                                                           device="cuda")})
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    server.start()
    tcp = f"127.0.0.1:{server.port}"
    endpoints = {"wire": ["-u", f"grpc:{tcp}", "--no-shm"],
                 "shm": ["-u", f"grpc:{tcp}", "--shm"],
                 "uds": ["-u", f"grpc:{server.uds_address}"]}
    want_transport = {"wire": "grpc", "shm": "shm", "uds": "uds+shm"}
    try:
        probe = GRPCChannel(tcp, use_shared_memory=False)
        meta = probe._stub.ServerMetadata(pb.ServerMetadataRequest(), timeout=30)
        check("system_shared_memory" in meta.extensions, f"ServerMetadata {meta.extensions}")
        probe.close()
        shm_fs = os.statvfs("/dev/shm")
        captures = {n: repo.get(n).infer_fn.graph_stats()["captures"] for n in repo.names()}

        # -- the in-process references (their own processes, on the card) ------------
        frames_arg = ["-i", f"synthetic:{REMOTE_FRAMES}:512x512"]
        local = {}
        for label, flags in (("b1", []), (f"b{B_MAIN}", ["-b", str(B_MAIN)])):
            local[label] = client_run("detect2d", ["-r", str(root), "-m", model_2d, *frames_arg,
                                                   *flags], tmp / f"local_2d_{label}", False)
        local["3d"] = client_run("detect3d", ["-r", str(root), "-m", REMOTE_3D, "-i",
                                              str(clouds)], tmp / "local_3d", False)

        # -- the counted window: every remote client, each transport ------------------------
        for counter in counters:
            counter.reset()
        clients, requests_2d, requests_3d = {}, 0, 0
        for transport in REMOTE_TRANSPORTS:
            for label, flags in REMOTE_2D_RUNS.items():
                report, rows = client_run(
                    "detect2d", ["-m", model_2d, *frames_arg, *flags, *endpoints[transport]],
                    tmp / f"{transport}_2d_{label}", True)
                want = local["b1" if label != f"b{B_MAIN}" else label]
                check(rows == want[1], f"detect2d {label} over {transport}: rows differ from "
                      "the in-process -r run")
                check(report["transport"] == want_transport[transport],
                      f"detect2d {label} over {transport} reports {report['transport']}")
                requests_2d += report["driver"]["ticks"] + 1  # and the driver's warmup call
                clients[f"detect2d_{label}_{transport}"] = {
                    "frames_per_s": report["driver"]["fps"], "p50_ms": report["driver"]["p50_ms"],
                    "frames": report["frames"], "detections": report["detections"],
                    "transport": report["transport"]}
            report, rows = client_run("detect3d", ["-m", REMOTE_3D, "-i", str(clouds),
                                                   *endpoints[transport]],
                                      tmp / f"{transport}_3d", True)
            check(rows == local["3d"][1], f"detect3d over {transport}: rows differ from the "
                  "in-process -r run")
            check(report["transport"] == want_transport[transport],
                  f"detect3d over {transport} reports {report['transport']}")
            requests_3d += report["driver"]["ticks"] + 1
            clients[f"detect3d_{transport}"] = {
                "scans_per_s": report["driver"]["fps"], "p50_ms": report["driver"]["p50_ms"],
                "scans": report["scans"], "detections": report["detections"],
                "transport": report["transport"]}
        torch.cuda.synchronize()
        launches = dict(zip(COUNTER_NAMES, (c.count for c in counters)))
        want_launches = {"decode_nms_2d": requests_2d, "greedy_nms": 0,
                         "residual_decode_3d": requests_3d, "suppress_pack_3d": requests_3d,
                         "segment_mean": 0, "segment_sum": 0,
                         "residual_decode_3d_gathered": requests_3d}
        check(launches == want_launches, f"remote launches {launches}, want {want_launches}")
        after = {n: repo.get(n).infer_fn.graph_stats()["captures"] for n in repo.names()}
        check(after == captures, "a request captured a graph inside the counted window")
        check(server.shm_registry.status() == {}, "a client left regions registered")
        check(local["b1"][0]["detections"] > 0 and local["3d"][0]["detections"] > 0,
              "the references kept nothing")

        # -- the wire split: YOLOv5 batch 1 and PointPillars 120k, each transport, from
        # this process and from a client process (no card visible, as the clients) --------
        legs = {"wire": (tcp, False), "shm": (tcp, True), "uds": (server.uds_address, True)}
        split = split_legs(legs, model_2d, str(clouds))
        proc = subprocess.run(
            [sys.executable, "-c", SPLIT_CHILD, str(ROOT), json.dumps(legs), model_2d,
             str(clouds)],
            cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), capture_output=True,
            text=True, timeout=600,
        )
        check(proc.returncode == 0, f"the client-process split exited {proc.returncode}: "
              f"{proc.stderr[-3000:]}")
        split_child = json.loads(proc.stdout.strip().splitlines()[-1])
    finally:
        server.stop()
        shutil.rmtree(tmp)
    emit("remote", card, write_s=write_s, build_and_capture_s=build_s,
         server={"tcp": tcp, "uds": server.uds_address},
         dev_shm_bytes={"size": shm_fs.f_frsize * shm_fs.f_blocks,
                        "free": shm_fs.f_frsize * shm_fs.f_bavail},
         clients_are_processes=True, bitwise_equal_to_in_process=True,
         launches=launches, requests={"2d": requests_2d, "3d": requests_3d},
         no_capture_in_window=True, clients=clients,
         in_process={k: {"frames_per_s": v[0]["driver"]["fps"],
                         "p50_ms": v[0]["driver"]["p50_ms"]} for k, v in local.items()},
         phase25_socket_leg=SERVED.get("socket_leg"), wire_split=split,
         wire_split_client_process=split_child, dequant_host=dequant_host())


# phase 28: examples/centerpoint_nusc (data/nusc_centerpoint.yaml at full
# width) and examples/pointpillar_wide; CenterPoint's scans are 10 sweeps of
# 26,000 points 0.05 s apart (260,000 points: the 262,144 bucket) and single
# 30,000-point sweeps (the 131,072 bucket); the remote clients replay
# CP_FILES sweeps, of which the last CP_FILES - 9 aggregate 10
CP_ENTRY, WIDE_ENTRY = "centerpoint_nusc", "pointpillar_wide"
CP_SWEEPS, CP_SWEEP_POINTS, CP_SINGLE_POINTS, CP_PERIOD = 10, 26000, 30000, 0.05
CP_FILES, CP_REQUESTS, WIDE_REQUESTS = 20, 20, 10
NUSC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
# card against CPU: rows matched by label and box centre within CP_MATCH_M
# metres; matched rows within CP_TOL in every column, and at least
# CP_MATCHED of the card's rows matched
CP_MATCH_M, CP_TOL, CP_MATCHED = 0.05, 1e-4, 0.9


def det3d_state(model) -> dict:
    """A seeded CenterPoint's weights under det3d's names, with a
    shared-conv bias added to the conv and to the BatchNorm mean after it,
    which ``runtime/importers.load_centerpoint`` folds back."""
    from triton_client_tpu_torch.runtime.importers import centerpoint_torch_key

    state = {centerpoint_torch_key(k): v.clone() for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    bias = torch.linspace(-0.1, 0.1, model.cfg.head_width)
    state["bbox_head.shared_conv.0.bias"] = bias
    state["bbox_head.shared_conv.1.running_mean"] += bias
    return state


def centerpoint_repository(tmp: pathlib.Path) -> tuple[pathlib.Path, pathlib.Path, pathlib.Path]:
    """The phase-28 repository root (``centerpoint_nusc`` with a seeded
    det3d-named ``1/weights.pth``, ``pointpillar_wide`` seeded), a
    directory of ``CP_FILES`` seeded sweeps over the nuScenes range and
    their poses (a platform moving 0.5 m and turning 0.01 rad a sweep)."""
    from triton_client_tpu_torch.runtime.disk_repository import _Entry

    root = tmp / "repo"
    for name in (CP_ENTRY, WIDE_ENTRY):
        (root / name).mkdir(parents=True)
        (root / name / "config.yaml").write_bytes(
            (ROOT / "examples" / name / "config.yaml").read_bytes())
    (root / CP_ENTRY / "1").mkdir()
    _, _, model = _Entry(root / CP_ENTRY, device="cpu")._build()  # seeded, on the host
    torch.save({"state_dict": det3d_state(model)}, root / CP_ENTRY / "1" / "weights.pth")
    sweeps = tmp / "sweeps"
    sweeps.mkdir()
    poses = tmp / "poses.jsonl"
    with open(poses, "w") as f:
        for i in range(CP_FILES):
            np.save(sweeps / f"{i:03d}.npy",
                    uniform_clouds(280 + i, NUSC_RANGE, CP_SWEEP_POINTS, 1)[0])
            yaw = 0.01 * i
            f.write(json.dumps({"frame_id": i, "pose": [0.5 * i, 0.0, 0.0, 0.0, 0.0,
                                                        float(np.sin(yaw / 2)),
                                                        float(np.cos(yaw / 2))]}) + "\n")
    return root, sweeps, poses


def recorded_suppress_args(run):
    """``run()`` with ``ops/detect3d_postprocess.fused_suppress_pack_3d``
    recording its arguments: the candidates the main path hands kernel 4.
    Returns (what ``run`` returned, (args, kwargs) of the one call)."""
    from triton_client_tpu_torch.ops import detect3d_postprocess as post

    seen, call = [], post.fused_suppress_pack_3d

    def record(*args, **kw):
        seen.append((args, kw))
        return call(*args, **kw)

    post.fused_suppress_pack_3d = record
    try:
        out = run()
    finally:
        post.fused_suppress_pack_3d = call
    torch.cuda.synchronize()
    check(len(seen) == 1, f"one scan called the suppress+pack wrapper {len(seen)} times")
    return out, seen[0]


def rows_matched_by_box(card: dict, cpu: dict) -> tuple[int, float]:
    """Each card row against the CPU row of its label whose box centre is
    nearest, within ``CP_MATCH_M``: (rows matched, the largest difference
    over their boxes, scores and velocities)."""
    matched, err = 0, 0.0
    for i in range(len(card["pred_scores"])):
        same = np.flatnonzero(cpu["pred_labels"] == card["pred_labels"][i])
        if not len(same):
            continue
        d = np.hypot(*(cpu["pred_boxes"][same, :2] - card["pred_boxes"][i, :2]).T)
        j = same[int(d.argmin())]
        if d.min() > CP_MATCH_M:
            continue
        matched += 1
        err = max(err, *(float(np.abs(card[k][i] - cpu[k][j]).max())
                         for k in ("pred_boxes", "pred_scores", "pred_velocities")))
    return matched, err


def run_centerpoint(card: str, counters) -> dict:
    """Phase 28: ``examples/centerpoint_nusc`` (CenterPoint with velocity,
    nuScenes, 10 sweeps, at full width) and ``examples/pointpillar_wide``
    served by ``serve`` (``cli/serve.build_server`` in this process) from a
    repository written here: CenterPoint's weights a seeded det3d-named
    ``weights.pth`` with a shared-conv bias, imported with no JAX.

    Held: kernel 4 bitwise equal to its plain version on the main path's
    own candidates (K = 128 rows of 11 columns, the velocity riding) at
    both buckets; the captured body bitwise equal to the eager one with
    equal launch counts at both buckets; the card against the CPU pipeline
    on the same weights (rows matched by box, ``CP_TOL``); through
    ``CUDAChannel`` exactly one kernel 4 launch a scan, no other kernel and
    no capture in the counted window, rows equal to the in-process
    pipeline's bit for bit, ``velocities`` the rows' columns 7:9; and
    ``detect3d -u grpc: --sweeps 10 --poses`` client processes with no card
    visible over the wire, shm and the unix socket, whose rows equal the
    in-process ``-r`` run's bit for bit and carry ``pred_velocities``.
    Prints p50 and scans/s at both buckets, device ms, busy share and the
    top device ops, ``stable_top_k``'s time over the 655,360 heatmap
    entries, kernel 4's ms, call ms, plain ms and bound at this shape,
    pointpillar_wide's p50, and the clients' p50. Returns kernel 4's
    numbers for the ``{"kernels": [...]}`` record."""
    import shutil
    import tempfile

    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.cli import serve as serve_cli
    from triton_client_tpu_torch.drivers.driver import channel_infer3d
    from triton_client_tpu_torch.io.bag_io import pose_lookup_from_jsonl
    from triton_client_tpu_torch.io.sources import NpyPointCloudSource, SyntheticPointCloudSource
    from triton_client_tpu_torch.ops import gpu_suppress3d, mask_scan
    from triton_client_tpu_torch.ops.detect_postprocess import stable_top_k
    from triton_client_tpu_torch.ops.sweeps import sweep_source
    from triton_client_tpu_torch.pipelines.detect3d import prepare_points
    from triton_client_tpu_torch.runtime.disk_repository import load_pipeline

    dev = torch.device("cuda")
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="centerpoint_repo_"))
    cwd = os.getcwd()
    os.chdir(ROOT)  # the entries name data/ files relative to the checkout
    try:
        t0 = time.perf_counter()
        root, sweeps_dir, poses = centerpoint_repository(tmp)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        args = serve_cli.parser().parse_args(["-r", str(root), "-a", "127.0.0.1:0", "--uds",
                                              "auto", "--warmup", "--max-workers", "8"])
        server = serve_cli.build_server(args)  # every entry's graphs captured
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        pipe, spec = load_pipeline(root / CP_ENTRY, device="cuda")
        cpu_pipe, _ = load_pipeline(root / CP_ENTRY, device="cpu")
    finally:
        os.chdir(cwd)
    try:
        repo, channel = server.servicer._repo, server.servicer._channel
        model, cfg = pipe.model, pipe.config
        served = repo.metadata(CP_ENTRY)
        check(model.cfg.voxel.grid_size == (512, 512, 1) and model.cfg.voxel.point_features == 5
              and model.cfg.head_hw == (256, 256) and model.cfg.with_velocity
              and cfg.nsweeps == CP_SWEEPS and tuple(cfg.point_buckets) == (131072, 262144)
              and cfg.iou_thresh == 0.2 and pipe.use_scatter, "not the nuScenes entry")
        check([(t.name, t.shape) for t in served.outputs] == [
            ("detections", (cfg.max_det, 11)), ("valid", (cfg.max_det,)),
            ("velocities", (cfg.max_det, 2))] and served.extra["with_velocity"] is True,
              f"served outputs {served.outputs}")
        check(served.extra["fused_stages"] == ["decode_nms"], "the tail is not fused on the card")

        # the scans: 10 sweeps aggregated with their poses on a 0.05 s replay clock
        frames = [f.data for f in sweep_source(
            NpyPointCloudSource(str(sweeps_dir), period=CP_PERIOD), CP_SWEEPS,
            pose_lookup_from_jsonl(str(poses)))]
        full = [d for d in frames if len(d) == CP_SWEEPS * CP_SWEEP_POINTS]
        check(len(full) == CP_FILES - CP_SWEEPS + 1 and full[0].shape[1] == 5,
              f"{len(full)} aggregated scans of 10 sweeps")
        lags = np.unique(full[0][:, 4])
        check(np.allclose(lags, np.arange(CP_SWEEPS) * CP_PERIOD, atol=1e-6), f"Δt {lags}")
        single = uniform_clouds(281, NUSC_RANGE, CP_SINGLE_POINTS, 2)  # 4 columns: Δt = 0
        scans = {262144: full, 131072: single}

        def on_card(pc):
            padded, m = prepare_points(pc, 5, cfg.point_buckets)
            return (torch.from_numpy(padded).to(dev),
                    torch.tensor(m, dtype=torch.int32).to(dev))

        # -- kernel 4 on the main path's own candidates; captured against eager --
        k4 = {}
        capture = {}
        for bucket, pcs in scans.items():
            a, b = on_card(pcs[0]), on_card(pcs[1])
            check(a[0].shape[0] == bucket, f"a scan padded to {a[0].shape[0]}, not {bucket}")
            (rows, keep), (cargs, ckw) = recorded_suppress_args(lambda: pipe.run(*a))
            iou, srows = gpu_suppress3d.sorted_candidates(*cargs)
            check(srows.shape == (1, 128, 11), f"kernel 4's rows {tuple(srows.shape)}")
            thresh, max_det = ckw["iou_thresh"], ckw["max_det"]
            # sorted_candidates hands them over in score order: taken as it stands
            got, ws, sizes = with_workspace(
                lambda: gpu_suppress3d.suppress_pack_3d(iou, srows, thresh, max_det))
            check(bool(mask_scan.took_own_order(ws, sizes).all()),
                  "the order pass sorted CenterPoint's candidates")
            del ws
            want = gpu_suppress3d.suppress_pack_3d_reference(iou, srows, thresh, max_det)
            check(torch.equal(got[1], want[1]) and torch.equal(bits(got[0]), bits(want[0])),
                  f"suppress_pack_3d differs on CenterPoint's candidates ({bucket})")
            check(torch.equal(bits(rows), bits(want[0][0])) and torch.equal(keep, want[1][0]),
                  f"the pipeline's rows differ from the plain suppress+pack ({bucket})")
            k4[bucket] = {"candidates": int(torch.isfinite(srows[0, :, 9]).sum()),
                          "kept": int(keep.sum()), "iou": iou, "srows": srows,
                          "thresh": thresh, "max_det": max_det}
            per_call, _, _ = hold_captured_to_eager(pipe, a, b, counters, f"centerpoint {bucket}")
            capture[bucket] = {c_name: n for c_name, n in zip(COUNTER_NAMES, per_call) if n}
            check(capture[bucket] == {"suppress_pack_3d": 1},
                  f"one eager CenterPoint scan launched {capture[bucket]}")
        emit("centerpoint_kernel4", card, shape=[1, 128, 128, 11],
             by_bucket={n: {k: v for k, v in r.items() if k not in ("iou", "srows")}
                        for n, r in k4.items()},
             match=True, max_abs_err=0.0, captured_equals_eager=True,
             eager_launches_per_scan=capture, replays=GRAPH_REPLAYS)

        # -- the card against the CPU pipeline, same weights, rows matched by box ---
        vs_cpu = {}
        for bucket, pcs in scans.items():
            g, c = pipe.infer(pcs[0]), cpu_pipe.infer(pcs[0])
            matched, err = rows_matched_by_box(g, c)
            n = len(g["pred_scores"])
            check(n > 0 and matched >= CP_MATCHED * n and err <= CP_TOL,
                  f"card against CPU at {bucket}: {matched} of {n} rows matched "
                  f"(CPU {len(c['pred_scores'])}), largest difference {err}")
            vs_cpu[bucket] = {"card_rows": n, "cpu_rows": len(c["pred_scores"]),
                              "matched": matched, "max_abs_err": err}

        # -- the main path: scans through CUDAChannel, counted ------------------------
        infer = channel_infer3d(channel, CP_ENTRY)
        for pcs in scans.values():  # warm-up, not counted
            infer(pcs[0])
        torch.cuda.synchronize()
        captures = {n: repo.get(n).infer_fn.graph_stats()["captures"] for n in repo.names()}
        requests = full + single
        for counter in counters:
            counter.reset()
        outs = [infer(pc) for pc in requests]
        torch.cuda.synchronize()
        launches = dict(zip(COUNTER_NAMES, (c.count for c in counters)))
        want_launches = {name: 0 for name in COUNTER_NAMES}
        want_launches["suppress_pack_3d"] = len(requests)
        check(launches == want_launches, f"CenterPoint launches {launches}, want {want_launches}")
        after = {n: repo.get(n).infer_fn.graph_stats()["captures"] for n in repo.names()}
        check(after == captures, "a request captured a graph inside the counted window")
        for pc, o in zip(requests, outs):
            n = len(o["pred_scores"])
            check(0 < n <= cfg.max_det and o["pred_boxes"].shape == (n, 7)
                  and o["pred_velocities"].shape == (n, 2), "misshapen rows")
            check(all(bool(np.isfinite(v).all()) for v in o.values()), "non-finite rows")
            check(1 <= o["pred_labels"].min() and o["pred_labels"].max() <= 10, "labels")
            want = pipe.infer(pc)
            check(all(o[k].tobytes() == want[k].tobytes() for k in want),
                  "the served rows differ from the in-process pipeline's")
        padded, m = prepare_points(full[0], 5, cfg.point_buckets)
        raw = channel.do_inference(InferRequest(
            CP_ENTRY, {"points": padded, "num_points": np.asarray(m, np.int32)})).outputs
        check(raw["velocities"].tobytes() == np.ascontiguousarray(
            raw["detections"][:, 7:9]).tobytes(), "velocities are not the rows' columns 7:9")
        emit("centerpoint_main_path", card, model=CP_ENTRY, grid=list(model.cfg.voxel.grid_size),
             head_hw=list(model.cfg.head_hw), points={"262144": len(full[0]),
                                                      "131072": len(single[0])},
             requests=len(requests), kept=[len(o["pred_scores"]) for o in outs],
             launches=launches, no_capture_in_window=True, bitwise_equal_in_process=True,
             card_vs_cpu=vs_cpu, write_s=write_s, build_and_capture_s=build_s,
             graphs=repo.get(CP_ENTRY).infer_fn.graph_stats(),
             param_bytes=served.extra["param_bytes"])

        # -- times on the card's clock ----------------------------------------------
        e2e = {f"bucket{n}": serve(infer, pcs, CP_REQUESTS) for n, pcs in scans.items()}
        with torch.no_grad():  # the decode's top-k input, as it builds it
            logits = model.from_points(*on_card(full[0]))["heatmap"]
            pooled = torch.nn.functional.max_pool2d(logits.permute(0, 3, 1, 2), 3, 1, 1)
            heat = torch.where(logits >= pooled.permute(0, 2, 3, 1), torch.sigmoid(logits), 0.0)
        flat = heat.reshape(1, -1)
        check(flat.shape[1] == 655360, f"{flat.shape[1]} heatmap entries")
        topk_ms = cuda_ms(lambda: stable_top_k(flat, model.cfg.max_objects), reps=50)
        r = k4[262144]
        iou, srows, thresh, max_det = r["iou"], r["srows"], r["thresh"], r["max_det"]
        k4_ms = kernel_device_ms(
            lambda: gpu_suppress3d.suppress_pack_3d(iou, srows, thresh, max_det),
            gpu_suppress3d.launches)
        k4_call_ms = cuda_ms(
            lambda: gpu_suppress3d.suppress_pack_3d(iou, srows, thresh, max_det), reps=200)
        k4_plain_ms = cuda_ms(
            lambda: gpu_suppress3d.suppress_pack_3d_reference(iou, srows, thresh, max_det),
            reps=5, warmup=1)
        tests, kept_steps = live_counts_3d(iou, srows[..., 9].clone(),
                                           torch.tensor(thresh, device=dev), max_det)
        k, cols = srows.shape[1], srows.shape[2]
        k4_bytes = kept_steps * k * 4 + k * cols * 4 + max_det * (cols * 4 + 1)
        k4_bound, k4_by = roofline(k4_bytes, tests)
        profiles = {f"bucket{n}": device_profile(lambda pc=pcs[0]: infer(pc), PROFILE_REQUESTS)
                    for n, pcs in scans.items()}
        wide = channel_infer3d(channel, WIDE_ENTRY)
        wide_scans = {n: [f.data for f in SyntheticPointCloudSource(2, points=n, seed=28 + i)]
                      for i, n in enumerate(SCAN_POINTS)}
        for pcs in wide_scans.values():
            check(len(wide(pcs[0])["pred_scores"]) > 0, "pointpillar_wide kept nothing")
        wide_e2e = {f"points{n}": serve(wide, pcs, WIDE_REQUESTS)
                    for n, pcs in wide_scans.items()}
        emit("centerpoint_times", card, in_process=e2e, stable_top_k_ms=topk_ms,
             stable_top_k_entries=int(flat.shape[1]),
             kernel4={"ms": k4_ms, "call_ms": k4_call_ms, "plain_ms": k4_plain_ms,
                      "bound_ms": k4_bound, "bound_by": k4_by, "bytes": k4_bytes,
                      "live_tests": tests, "kept_steps": kept_steps,
                      "shape": [1, k, max_det, cols]},
             profile=profiles, pointpillar_wide={
                 "in_process": wide_e2e, "param_bytes": repo.metadata(WIDE_ENTRY)
                 .extra["param_bytes"]})

        # -- detect3d -u grpc: --sweeps 10 --poses client processes --------------------
        server.start()
        tcp = f"127.0.0.1:{server.port}"
        endpoints = {"wire": ["-u", f"grpc:{tcp}", "--no-shm"],
                     "shm": ["-u", f"grpc:{tcp}", "--shm"],
                     "uds": ["-u", f"grpc:{server.uds_address}"]}
        want_transport = {"wire": "grpc", "shm": "shm", "uds": "uds+shm"}
        sweep_args = ["-i", str(sweeps_dir), "--sweeps", str(CP_SWEEPS), "--poses", str(poses),
                      "--scan-period", str(CP_PERIOD)]
        local = client_run("detect3d", ["-r", str(root), "-m", CP_ENTRY, *sweep_args],
                           tmp / "local_cp", False)
        captures = {n: repo.get(n).infer_fn.graph_stats()["captures"] for n in repo.names()}
        for counter in counters:
            counter.reset()
        clients, requests_3d = {}, 0
        for transport in REMOTE_TRANSPORTS:
            report, rows = client_run("detect3d", ["-m", CP_ENTRY, *sweep_args,
                                                   *endpoints[transport]],
                                      tmp / f"{transport}_cp", True)
            check(rows == local[1], f"detect3d --sweeps over {transport}: rows differ from the "
                  "in-process -r run")
            check(all(len(r["pred_velocities"]) == len(r["pred_scores"]) for r in rows),
                  "rows without pred_velocities")
            check(report["transport"] == want_transport[transport],
                  f"detect3d over {transport} reports {report['transport']}")
            requests_3d += report["driver"]["ticks"] + 1  # and the driver's warmup call
            clients[f"detect3d_{transport}"] = {
                "scans_per_s": report["driver"]["fps"], "p50_ms": report["driver"]["p50_ms"],
                "scans": report["scans"], "detections": report["detections"],
                "transport": report["transport"]}
        torch.cuda.synchronize()
        remote_launches = dict(zip(COUNTER_NAMES, (c.count for c in counters)))
        want_launches["suppress_pack_3d"] = requests_3d
        check(remote_launches == want_launches,
              f"remote launches {remote_launches}, want {want_launches}")
        after = {n: repo.get(n).infer_fn.graph_stats()["captures"] for n in repo.names()}
        check(after == captures, "a request captured a graph inside the counted window")
        check(local[0]["detections"] > 0 and local[0]["sweeps"] == CP_SWEEPS,
              f"the reference run {local[0]}")
        emit("centerpoint_remote", card, sweeps=CP_SWEEPS, files=CP_FILES,
             request_bytes=int(np.dtype(np.float32).itemsize * 262144 * 5),
             clients_are_processes=True, bitwise_equal_to_in_process=True,
             launches=remote_launches, requests=requests_3d, no_capture_in_window=True,
             clients=clients, in_process={"scans_per_s": local[0]["driver"]["fps"],
                                          "p50_ms": local[0]["driver"]["p50_ms"]})
    finally:
        server.stop()
        shutil.rmtree(tmp)
    return {"launches": launches["suppress_pack_3d"], "ms": k4_ms, "call_ms": k4_call_ms,
            "plain_ms": k4_plain_ms, "bound_ms": k4_bound, "bound_by": k4_by,
            "shape": [1, k, max_det, cols]}


# phase 29: every serving precision policy on every served family. The 3D
# entries as they stand, seeded (seed 0), through scan_disk's precision
# override at f32, bf16 and int8w; examples/yolov5_crop_base at conf 0.05
# (seeded weights keep nothing at its 0.3) at f32, int8w and a calibrated
# int8. The same seeded weights under every policy
PREC_3D = {"pointpillar_kitti": "pointpillars", "second_iou": "second_iou",
           "centerpoint_nusc": "centerpoint"}  # entry -> family
PREC_2D = "yolov5_crop_base"
PREC_POLICIES_3D = ("f32", "bf16", "int8w")
PREC_POLICIES_2D = ("f32", "int8w", "int8")
PREC_SCANS, PREC_REQUESTS, PREC_FRAMES = 3, 10, 8
# a KITTI scan of a full HDL-64 (the 131,072 bucket); CenterPoint's 10
# sweeps of 26,000 points (the 262,144 bucket)
PREC_POINTS = {"pointpillar_kitti": 120000, "second_iou": 120000, "centerpoint_nusc": 260000}


def precision_scans(name: str, voxel, count: int, seed: int) -> list[np.ndarray]:
    """``count`` seeded clouds of ``PREC_POINTS[name]`` points over the
    entry's range; CenterPoint's carry a fifth column, the sweep's lag (10
    sweeps 0.05 s apart)."""
    clouds = uniform_clouds(seed, voxel.point_cloud_range, PREC_POINTS[name], count)
    if voxel.point_features == 5:
        rng = np.random.default_rng(seed + 1)
        clouds = [np.column_stack([pc, (rng.integers(0, 10, len(pc)) * 0.05)]).astype(np.float32)
                  for pc in clouds]
    return clouds


def pipeline_of(registered):
    """The pipeline behind a registered model's captured body."""
    return registered.infer_fn.graph_stats.__self__


def recorded_kernel_calls(run) -> tuple:
    """``run()`` with the kernel wrappers a served path calls recording their
    arguments (kernel 1's fused 2D tail, kernel 3's gathered decode, kernel
    4's suppress + pack, kernel 5's segment mean). Returns (what ``run``
    returned, {kernel: [(args, kwargs), ...]})."""
    from triton_client_tpu_torch.ops import detect3d_postprocess, detect_postprocess, gpu_voxel
    from triton_client_tpu_torch.pipelines import detect3d

    sites = {"decode_nms_2d": (detect_postprocess, "fused_decode_nms_2d"),
             "residual_decode_3d_gathered": (detect3d, "gather_residual_decode"),
             "suppress_pack_3d": (detect3d_postprocess, "fused_suppress_pack_3d"),
             "segment_mean": (gpu_voxel, "sorted_segment_mean")}
    seen = {k: [] for k in sites}
    saved = {k: getattr(mod, attr) for k, (mod, attr) in sites.items()}

    def recorder(kernel):
        def record(*args, **kw):
            seen[kernel].append((args, kw))
            return saved[kernel](*args, **kw)
        return record

    for kernel, (mod, attr) in sites.items():
        setattr(mod, attr, recorder(kernel))
    try:
        out = run()
    finally:
        for kernel, (mod, attr) in sites.items():
            setattr(mod, attr, saved[kernel])
    torch.cuda.synchronize()
    return out, {k: v for k, v in seen.items() if v}


def kernels_equal_plain(calls: dict, label: str) -> dict:
    """Each recorded kernel call against its plain version on the same
    inputs, bitwise. Returns the shapes compared."""
    from triton_client_tpu_torch.ops import gpu_decode, gpu_decode3d, gpu_suppress3d, gpu_voxel

    shapes = {}
    for kernel, recorded in calls.items():
        for args, kw in recorded:
            if kernel == "suppress_pack_3d":
                iou, rows = gpu_suppress3d.sorted_candidates(*args[:3])
                rest = tuple(args[3:]) + tuple(kw[k] for k in ("iou_thresh", "max_det") if k in kw)
                got = gpu_suppress3d.suppress_pack_3d(iou, rows, *rest)
                want = gpu_suppress3d.suppress_pack_3d_reference(iou, rows, *rest)
                shape = list(rows.shape)
            elif kernel == "decode_nms_2d":
                got = gpu_decode.fused_decode_nms_2d(*args, **kw)
                want = gpu_decode.decode_nms_2d_reference(*args, **kw)
                shape = list(args[0].shape)
            elif kernel == "residual_decode_3d_gathered":
                got = (gpu_decode3d.gather_residual_decode(*args, **kw),)
                want = (gpu_decode3d.gather_residual_decode_reference(*args, **kw),)
                shape = list(args[3].shape)
            else:
                got = (gpu_voxel.sorted_segment_mean(*args, **kw),)
                want = (gpu_voxel.sorted_segment_mean_reference(*args, **kw),)
                shape = list(args[0].shape) + [int(args[2])]
            check(all(torch.equal(bits(g) if g.dtype == torch.float32 else g,
                                  bits(w) if w.dtype == torch.float32 else w)
                      for g, w in zip(got, want)),
                  f"{label}: {kernel} differs from its plain version on the path's own inputs")
            shapes[kernel] = shape
    return shapes


def heads_distance(a: dict, b: dict) -> float:
    return max(float((a[k].float().cpu() - b[k].float().cpu()).abs().max()) for k in a)


_TINY: dict = {}


def precision_tiny_pair(family: str, policy: str) -> tuple:
    """A family at the CPU tests' tiny grid, seeded, on the card and on the
    CPU under ``policy`` (once a phase), and four clouds over its range."""
    from triton_client_tpu_torch.models.centerpoint import CenterPointConfig
    from triton_client_tpu_torch.models.pointpillars import PointPillarsConfig
    from triton_client_tpu_torch.models.second import SECONDConfig
    from triton_client_tpu_torch.ops.voxelize import VoxelConfig
    from triton_client_tpu_torch.pipelines.detect3d import BUILDERS_3D, Detect3DConfig

    if family == "pointpillars":
        mcfg = PointPillarsConfig(voxel=VoxelConfig(
            point_cloud_range=(0.0, -6.4, -3.0, 12.8, 6.4, 1.0), voxel_size=(0.2, 0.2, 4.0),
            max_voxels=512, max_points_per_voxel=8), backbone_layers=(1, 1, 1))
        cfg = Detect3DConfig(point_buckets=(2048,), max_det=16, pre_max=64)
    elif family == "second_iou":
        mcfg = SECONDConfig(
            voxel=VoxelConfig(point_cloud_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0),
                              voxel_size=(0.5, 0.5, 0.5), max_voxels=1024, max_points_per_voxel=5),
            middle_filters=(8, 16), backbone_layers=(1, 1), backbone_filters=(16, 32),
            upsample_filters=(16, 16))
        cfg = Detect3DConfig(model_name="second_iou", point_buckets=(1024,), max_det=16,
                             pre_max=64)
    else:
        mcfg = CenterPointConfig(
            voxel=VoxelConfig(point_cloud_range=(-6.4, -6.4, -5.0, 6.4, 6.4, 3.0),
                              voxel_size=(0.2, 0.2, 8.0), max_voxels=512, max_points_per_voxel=8,
                              point_features=5),
            backbone_layers=(1, 1, 1), backbone_filters=(16, 32, 64), upsample_filters=(16, 16, 16),
            vfe_filters=16, head_width=16, max_objects=32)
        cfg = Detect3DConfig(model_name="centerpoint", iou_thresh=0.2, point_buckets=(1024,),
                             max_det=16)
    if (family, policy) not in _TINY:
        _TINY[family, policy] = [
            BUILDERS_3D[family](mcfg, dataclasses.replace(cfg, fused="on"), device=d, seed=0,
                                precision=policy)[0] for d in ("cuda", "cpu")]
    clouds = uniform_clouds(29, mcfg.voxel.point_cloud_range, 500, 4)
    if mcfg.voxel.point_features == 5:
        clouds = [np.column_stack([pc, np.full(len(pc), 0.05, np.float32)]) for pc in clouds]
    return _TINY[family, policy], clouds


def precision_card_vs_cpu(family: str, policy: str) -> dict:
    """The card against the CPU port at a tiny grid under ``policy`` (same
    seed, same weights). f32 and int8w (float32 compute): equal kept counts
    and labels and rows within 1e-5 (CenterPoint's rows matched by box, as
    phase 28). bf16: both devices round every layer to bfloat16, after
    float32 sums in other orders, so a bfloat16 rounding can differ; held
    as the CPU tests hold the port to JAX: the card's bf16 heads no further
    from the CPU's f32 heads than twice the CPU's own bf16 distance. Then the
    card's detections under ``policy`` scored against the card's f32 ones on
    the same clouds, at least the f32 self-score less ``MAP_BUDGETS[policy]``
    (the bar tests/test_torch_precision_3d.py holds on the CPU)."""
    from triton_client_tpu_torch.pipelines.detect3d import prepare_points
    from triton_client_tpu_torch.runtime.precision import MAP_BUDGETS

    pipes, clouds = precision_tiny_pair(family, policy)
    out = {}
    if policy == "bf16":
        f32_cpu = precision_tiny_pair(family, "f32")[0][1]
        ratios = []
        for pc in clouds:
            padded, m = prepare_points(pc, pipes[1].model.cfg.voxel.point_features,
                                       pipes[1].config.point_buckets)
            args = [(torch.from_numpy(padded).to(d), torch.tensor(m, dtype=torch.int32).to(d))
                    for d in ("cuda", "cpu")]
            with torch.no_grad():
                card_h, cpu_h = pipes[0].heads(*args[0]), pipes[1].heads(*args[1])
                ref = f32_cpu.heads(*args[1])
            d_card, d_cpu = heads_distance(card_h, ref), heads_distance(cpu_h, ref)
            check(0 < d_card <= 2 * d_cpu, f"{family} bf16: the card's heads are {d_card} from "
                  f"the CPU's f32 ones, the CPU's bf16 {d_cpu}")
            ratios.append(d_card / d_cpu)
            out["card_cpu_bf16_heads_max_abs"] = max(out.get("card_cpu_bf16_heads_max_abs", 0.0),
                                                     heads_distance(card_h, cpu_h))
        out["card_over_cpu_bf16_distance"] = max(ratios)
    elif family == "centerpoint":
        for pc in clouds:
            g, c = pipes[0].infer(pc), pipes[1].infer(pc)
            matched, err = rows_matched_by_box(g, c)
            n = len(g["pred_scores"])
            check(n > 0 and matched >= CP_MATCHED * n and err <= 1e-5,
                  f"centerpoint {policy} card against CPU: {matched} of {n} rows, {err}")
            out["matched"] = out.get("matched", 0) + matched
            out["max_abs_err"] = max(out.get("max_abs_err", 0.0), err)
    else:
        out["max_abs_err"], out["kept"] = card_vs_cpu(pipes[0], pipes[1], clouds)
    if policy != "f32":
        ref = [precision_tiny_pair(family, "f32")[0][0].infer(pc) for pc in clouds]
        got, self_map = map_3d([pipes[0].infer(pc) for pc in clouds], ref), map_3d(ref, ref)
        check(got >= self_map - MAP_BUDGETS[policy],
              f"{family} {policy}: tiny-grid mAP {got} against f32, floor "
              f"{self_map - MAP_BUDGETS[policy]}")
        out.update(map_against_f32=got, map_floor=self_map - MAP_BUDGETS[policy])
    return out


def map_3d(rows: list[dict], ref: list[dict]) -> float:
    """The port's Detection3DEvaluator over ``rows``, with ``ref``'s
    detections as ground truth."""
    from triton_client_tpu_torch.eval.detection_map import Detection3DEvaluator

    ev = Detection3DEvaluator()
    for r, g in zip(rows, ref):
        gt = np.concatenate([g["pred_boxes"], g["pred_labels"][:, None] - 1.0], 1)
        ev.add_frame3d(r["pred_boxes"], r["pred_scores"], r["pred_labels"], gt)
    return float(ev.summary()["map"])


def map_2d(dets, valid, ref_dets, ref_valid) -> float:
    from triton_client_tpu_torch.eval.detection_map import DetectionEvaluator

    ev = DetectionEvaluator()
    for d, v, rd, rv in zip(dets, valid, ref_dets, ref_valid):
        ev.add_frame(d, v, rd[rv][:, [0, 1, 2, 3, 5]])
    return float(ev.summary()["map"])


def precision_repositories(tmp: pathlib.Path, calib: np.ndarray) -> tuple[dict, dict]:
    """The phase-29 repositories: the 3D entries under each of
    ``PREC_POLICIES_3D`` and the 2D entry under each of
    ``PREC_POLICIES_2D`` (``int8`` calibrated on ``calib``), every one
    scanned by ``scan_disk`` with its policy as the repository-wide
    override and its graphs captured at registration."""
    from triton_client_tpu_torch.runtime.disk_repository import scan_disk
    from triton_client_tpu_torch.runtime.precision import PrecisionPolicy

    for name in PREC_3D:
        (tmp / "3d" / name).mkdir(parents=True)
        (tmp / "3d" / name / "config.yaml").write_bytes(
            (ROOT / "examples" / name / "config.yaml").read_bytes())
    (tmp / "2d" / PREC_2D).mkdir(parents=True)
    text = (ROOT / "examples" / PREC_2D / "config.yaml").read_text()
    check("conf_thresh: 0.3" in text, f"examples/{PREC_2D} changed its conf_thresh")
    (tmp / "2d" / PREC_2D / "config.yaml").write_text(
        text.replace("conf_thresh: 0.3", "conf_thresh: 0.05"))
    repos_3d = {p: scan_disk(tmp / "3d", precision=None if p == "f32" else p)
                for p in PREC_POLICIES_3D}
    overrides = {"f32": None, "int8w": "int8w",
                 "int8": PrecisionPolicy("int8").calibrated({"images": calib})}
    repos_2d = {p: scan_disk(tmp / "2d", precision=overrides[p]) for p in PREC_POLICIES_2D}
    for repo in (*repos_3d.values(), *repos_2d.values()):
        for name, version in repo.list_models():
            repo.get(name, version).warmup()
    return repos_3d, repos_2d


def run_precision(card: str, counters) -> dict:
    """Phase 29: every serving precision policy on every served family.
    ``scan_disk`` with a repository-wide policy over the full-width 3D
    entries (PointPillars, SECOND-IoU, CenterPoint with velocity) at f32,
    bf16 and int8w and over ``yolov5_crop_base`` (conf 0.05) at f32, int8w
    and a calibrated int8, the same seeded weights under every policy, each
    through ``CUDAChannel`` with its graphs captured at registration.

    Held, for each entry and policy: the path's kernels (1 on the 2D
    entry; 3, 4 and 5 on the anchor 3D entries; 4 on CenterPoint) bitwise
    equal to their plain versions on the path's own inputs, recorded from
    an eager run; the captured body bitwise equal to the eager one with
    equal launches; through the channel, one launch of each of the path's
    kernels a request, no other and no capture, the counts set to 0 just
    before each path and read just after; ``points`` staged float32 under
    every policy and the calibrated int8 entry's ``images`` staged int8 (a
    quarter of the bytes); the card against the CPU port at a tiny grid
    (``precision_card_vs_cpu``); the detections' mAP against the f32
    entry's on the same inputs at least the f32 self-score less
    ``MAP_BUDGETS[policy]``. Prints p50 and scans/s or frames/s, device ms
    a request, busy share and top device ops, ``param_bytes`` and the
    graph-pool bytes of every entry. Returns the launches by path."""
    import shutil
    import tempfile

    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.channel.staged import cast_wire_input
    from triton_client_tpu_torch.drivers.driver import channel_infer3d
    from triton_client_tpu_torch.pipelines.detect2d import build_yolov5_pipeline
    from triton_client_tpu_torch.pipelines.detect3d import prepare_points
    from triton_client_tpu_torch.runtime.precision import MAP_BUDGETS

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(29)
    frames = rng.integers(0, 256, (PREC_FRAMES + 1, 512, 512, 3)).astype(np.float32)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="precision_repo_"))
    cwd = os.getcwd()
    os.chdir(ROOT)  # the entries name data/ files relative to the checkout
    try:
        t0 = time.perf_counter()
        repos_3d, repos_2d = precision_repositories(tmp, frames)
        build_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp)
    channels = {("3d", p): CUDAChannel(r) for p, r in repos_3d.items()}
    channels.update({("2d", p): CUDAChannel(r) for p, r in repos_2d.items()})
    launches_by_path, lines = {}, {}

    def counted(label, run, want: dict):
        """``run()`` between the counters set to 0 and read: the path's
        launches, held to ``want``, with no capture in the window."""
        caps = {(k, n): channels[k]._repository.get(n).infer_fn.graph_stats()["captures"]
                for k in channels for n in channels[k]._repository.names()}
        for c in counters:
            c.reset()
        out = run()
        torch.cuda.synchronize()
        got = {n: c.count for n, c in zip(COUNTER_NAMES, counters)}
        full = {n: want.get(n, 0) for n in COUNTER_NAMES}
        check(got == full, f"{label}: launches {got}, want {full}")
        after = {(k, n): channels[k]._repository.get(n).infer_fn.graph_stats()["captures"]
                 for k in channels for n in channels[k]._repository.names()}
        check(after == caps, f"{label}: a request captured a graph inside the counted window")
        launches_by_path[label] = {n: v for n, v in got.items() if v}
        return out

    # -- the 3D entries ---------------------------------------------------------------------
    for name in PREC_3D:
        f32_pipe = pipeline_of(repos_3d["f32"].get(name))
        voxel, cfg, family = f32_pipe.model.cfg.voxel, f32_pipe.config, PREC_3D[name]
        scans = precision_scans(name, voxel, PREC_SCANS, 290 + list(PREC_3D).index(name))
        per_request = {"pointpillars": {"residual_decode_3d": 1, "suppress_pack_3d": 1,
                                        "residual_decode_3d_gathered": 1},
                       "second_iou": {"residual_decode_3d": 1, "suppress_pack_3d": 1,
                                      "residual_decode_3d_gathered": 1, "segment_mean": 1},
                       "centerpoint": {"suppress_pack_3d": 1}}[family]

        def on_card(pc):
            padded, m = prepare_points(pc, voxel.point_features, cfg.point_buckets)
            return (torch.from_numpy(padded).to(dev), torch.tensor(m, dtype=torch.int32).to(dev))

        rows, line = {}, {}
        for policy in PREC_POLICIES_3D:
            registered = repos_3d[policy].get(name)
            pipe, spec = pipeline_of(registered), registered.spec
            label = f"{name}_{policy}"
            check(spec.extra["precision"] == policy and pipe.precision.name == policy,
                  f"{label}: the policy did not reach the entry")
            check(spec.extra["precision_keep_f32"] == ["voxelize_coords", "box_decode",
                                                       "nms_scores"], f"{label}: keep-list")
            check(spec.extra["fused_stages"] == list(f32_pipe.fused_stages) and "decode_nms" in
                  spec.extra["fused_stages"], f"{label}: not fused on the card")
            # the kernels on the path's own inputs, from an eager run
            a, b = on_card(scans[0]), on_card(scans[1])
            _, calls = recorded_kernel_calls(lambda: pipe.run(*a))
            check(set(calls) == {k for k in per_request if k != "residual_decode_3d"},
                  f"{label}: the eager run called {sorted(calls)}")
            shapes = kernels_equal_plain(calls, label)
            per_call, _, _ = hold_captured_to_eager(pipe, a, b, counters, label)
            check({c: n for c, n in zip(COUNTER_NAMES, per_call) if n} == per_request,
                  f"{label}: one eager scan launched {per_call}")
            # points staged float32: what the channel uploads a request
            padded, m = prepare_points(scans[0], voxel.point_features, cfg.point_buckets)
            wire = cast_wire_input(registered, "points", padded)
            chan = channels[("3d", policy)]
            staged, slot = chan._upload({"points": wire})
            if slot is not None:
                chan._give_slot(slot)
            check(wire.dtype == np.float32 and staged["points"].dtype == torch.float32,
                  f"{label}: points staged {staged['points'].dtype}")
            infer = channel_infer3d(chan, name)
            infer(scans[0])  # the channel's first request, outside the window
            outs = counted(label, lambda: [infer(pc) for pc in scans],
                           {k: v * len(scans) for k, v in per_request.items()})
            for pc, o in zip(scans, outs):
                want = pipe.infer(pc)
                check(all(o[k].tobytes() == want[k].tobytes() for k in want),
                      f"{label}: served rows differ from the in-process pipeline's")
                check(len(o["pred_scores"]) > 0 and all(bool(np.isfinite(v).all())
                                                       for v in o.values()),
                      f"{label}: no finite rows")
            rows[policy] = outs
            t = serve(infer, scans, PREC_REQUESTS)
            prof = device_profile(lambda: infer(scans[0]), PROFILE_REQUESTS)
            line[policy] = {
                "scans_per_s": t["scans_per_s"], "p50_ms": t["p50_ms"],
                "device_ms": prof["device_ms_per_request"],
                "busy_share": prof["device_busy_share"],
                "top_device_ops_ms": prof["top_device_ops_ms_per_request"],
                "param_bytes": spec.extra["param_bytes"],
                "pool_bytes": registered.infer_fn.graph_stats()["pool_bytes"],
                "graph_keys": registered.infer_fn.graph_stats()["keys"],
                "points_staged": str(staged["points"].dtype),
                "request_bytes": int(wire.nbytes), "kernel_shapes": shapes,
                "eager_launches_per_scan": {c: n for c, n in zip(COUNTER_NAMES, per_call) if n},
                "kept": [len(o["pred_scores"]) for o in outs],
                "card_vs_cpu_tiny": precision_card_vs_cpu(family, policy)}
            if family == "centerpoint":
                # one 30,000-point sweep: the 131,072 bucket, where ~101,000
                # padding rows contend on the pillar max's dump row
                sweep = uniform_clouds(299, voxel.point_cloud_range, CP_SINGLE_POINTS, 1)[0]
                infer(sweep)
                p131 = device_profile(lambda: infer(sweep), PROFILE_REQUESTS)
                line[policy]["bucket131072"] = {
                    "device_ms": p131["device_ms_per_request"],
                    "busy_share": p131["device_busy_share"],
                    "scatter_ms": sum(ms for op, ms in p131["top_device_ops_ms_per_request"].items()
                                      if "scatter" in op),
                    "top_device_ops_ms": p131["top_device_ops_ms_per_request"]}
        # at full width, reported: seeded weights are not stable to rounding at
        # this depth (PERF.md §6); the budget is held at the tiny grid
        # above, as on the CPU
        ref = rows["f32"]
        self_map = map_3d(ref, ref)
        for policy in PREC_POLICIES_3D[1:]:
            line[policy]["map_against_f32_full_width"] = map_3d(rows[policy], ref)
            line[policy]["budget_floor_full_width"] = self_map - MAP_BUDGETS[policy]
        line["f32"]["map_self"] = self_map
        lines[name] = line
        emit("precision_3d", card, entry=name, family=family, points=PREC_POINTS[name],
             bucket=int(on_card(scans[0])[0].shape[0]), scans=PREC_SCANS,
             policies=line, captured_equals_eager=True, kernels_equal_plain=True,
             no_capture_in_window=True)

    # -- the 2D entry -----------------------------------------------------------------------
    line2d = {}
    ref_out = None
    for policy in PREC_POLICIES_2D:
        registered = repos_2d[policy].get(PREC_2D)
        pipe, spec = pipeline_of(registered), registered.spec
        chan = channels[("2d", policy)]
        label = f"{PREC_2D}_{policy}"
        check(spec.extra["precision"] == policy, f"{label}: the policy did not reach the entry")
        wires, staged = {}, {}
        for b in (1, PREC_FRAMES):
            x = frames[:b] if b == 1 else frames[1:1 + b]
            wires[b] = cast_wire_input(registered, "images", x)
            staged[b], slot = chan._upload({"images": wires[b]})
            if slot is not None:
                chan._give_slot(slot)
        want_dtype = torch.int8 if policy == "int8" else torch.float32
        check(staged[1]["images"].dtype == want_dtype == pipe.precision.wire_dtype("images"),
              f"{label}: images staged {staged[1]['images'].dtype}")
        check(wires[1].nbytes == frames[:1].nbytes // (4 if policy == "int8" else 1),
              f"{label}: {wires[1].nbytes} bytes a frame")
        a, bb = (staged[PREC_FRAMES]["images"],), (staged[1]["images"].expand(
            PREC_FRAMES, -1, -1, -1).contiguous(),)
        _, calls = recorded_kernel_calls(lambda: pipe.run(*a))
        check(set(calls) == {"decode_nms_2d"}, f"{label}: the eager run called {sorted(calls)}")
        shapes = kernels_equal_plain(calls, label)
        per_call, _, _ = hold_captured_to_eager(pipe, a, bb, counters, label)
        check({c: n for c, n in zip(COUNTER_NAMES, per_call) if n} == {"decode_nms_2d": 1},
              f"{label}: one eager batch launched {per_call}")
        reqs = {b: InferRequest(PREC_2D, {"images": frames[:1] if b == 1 else frames[1:1 + b]})
                for b in (1, PREC_FRAMES)}
        for r in reqs.values():  # batch 8 captures here, before the window
            chan.do_inference(r)
        outs = counted(label, lambda: {b: chan.do_inference(r).outputs for b, r in reqs.items()},
                       {"decode_nms_2d": 2})
        out8 = outs[PREC_FRAMES]
        check(out8["detections"].dtype == np.float32 and bool(np.isfinite(out8["detections"])
                                                               .all()),
              f"{label}: detections not finite float32")
        if policy == "f32":
            ref_out = out8
            check(int(out8["valid"].sum()) > 0, "conf 0.05 kept nothing")
        times = {f"b{b}": serve(lambda _x, r=r: chan.do_inference(r), [None], PREC_REQUESTS,
                                "frames_per_s", lambda _x, b=b: b) for b, r in reqs.items()}
        prof = device_profile(lambda: chan.do_inference(reqs[PREC_FRAMES]), PROFILE_REQUESTS)
        # the card against the CPU port at 128^2 (phase 4's bar)
        small = dataclasses.replace(pipe.config, input_hw=(128, 128), max_det=100)
        policy_arg = pipe.precision
        g_pipe, c_pipe = (build_yolov5_pipeline(num_classes=NC, input_hw=(128, 128), config=small,
                                                device=d, seed=0, precision=policy_arg)[0]
                          for d in ("cuda", "cpu"))
        sframes = np.random.default_rng(4).integers(0, 255, (2, 96, 128, 3)).astype(np.float32)
        if policy == "int8":  # the int8 wire, dequantized in the body, on both devices
            sframes = policy_arg.wire_cast("images", sframes)
        (gd, gv), (cd, cv) = g_pipe.infer(sframes), c_pipe.infer(sframes)
        top_err = float(np.abs(gd[:, :5] - cd[:, :5]).max())
        check(np.array_equal(gv.sum(1), cv.sum(1)) and np.allclose(
            gd[:, :5], cd[:, :5], rtol=1e-2, atol=1e-2),
              f"{label}: card and CPU differ ({gv.sum()} / {cv.sum()} kept, {top_err})")
        line2d[policy] = {
            "times": times, "device_ms_b8": prof["device_ms_per_request"],
            "busy_share_b8": prof["device_busy_share"],
            "top_device_ops_ms_b8": prof["top_device_ops_ms_per_request"],
            "param_bytes": spec.extra["param_bytes"],
            "pool_bytes": registered.infer_fn.graph_stats()["pool_bytes"],
            "graph_keys": registered.infer_fn.graph_stats()["keys"],
            "images_staged": str(staged[1]["images"].dtype), "bytes_a_frame": int(wires[1].nbytes),
            "kernel_shapes": shapes, "kept_b8": int(out8["valid"].sum()),
            "card_vs_cpu_128": {"kept": int(gv.sum()), "top5_max_abs_err": top_err}}
        if policy != "f32":
            got = map_2d(out8["detections"], out8["valid"], ref_out["detections"],
                         ref_out["valid"])
            self_map = map_2d(ref_out["detections"], ref_out["valid"], ref_out["detections"],
                              ref_out["valid"])
            floor = self_map - MAP_BUDGETS[policy]
            check(got >= floor, f"{label}: mAP {got} against f32, floor {floor}")
            line2d[policy].update(map_against_f32=got, map_floor=floor, map_self=self_map)
    if "int8" in line2d:
        line2d["int8"]["act_scales"] = dict(repos_2d["int8"].get(PREC_2D).precision.act_scales)
    emit("precision_2d", card, entry=PREC_2D, conf_thresh=0.05, frames=PREC_FRAMES,
         input_hw=[512, 512], policies=line2d, captured_equals_eager=True,
         kernels_equal_plain=True, no_capture_in_window=True)
    wall = time.perf_counter() - t_phase
    emit("precision", card, wall_s=wall, build_and_capture_s=build_s,
         launches_by_path=launches_by_path,
         pool_bytes_total=sum(r.get(n).infer_fn.graph_stats()["pool_bytes"]
                              for r in (*repos_3d.values(), *repos_2d.values())
                              for n in r.names()),
         reserved_bytes=torch.cuda.memory_reserved(dev))
    return launches_by_path


def _only(root: pathlib.Path, name: str, dest: pathlib.Path) -> pathlib.Path:
    """A repository root holding one entry of ``root`` (config and weights)."""
    import shutil

    shutil.copytree(root / name, dest / name)
    return dest


# phase 30: replay and evaluation from bags. 2D frames at the entry's 512²,
# KITTI scans with the clutter raised to ~120,000 points (the full HDL-64
# scan of phases 10 and 15), nuScenes sweeps of ~30,000 points; the scans
# 1/8 s apart (synthdata.REPLAY_PERIOD, stamps a bag holds exactly)
REPLAY_FRAMES, REPLAY_SCANS, REPLAY_SWEEPS, REPLAY_HW = 32, 8, 20, (512, 512)
# ~25,000 points a sweep, so that ten fit the largest bucket (262,144) as
# phase 28's do
REPLAY_KITTI, REPLAY_NUSC = dict(n_clutter=118_000), dict(n_clutter=24_000, pc_range=NUSC_RANGE)
REPLAY_READS = 1  # passes over each source for the host read-and-decode time


def optional_package(name: str) -> bool:
    """Whether ``name`` imports here (a package that imports and then fails
    in a leg fails the run)."""
    import importlib

    try:
        importlib.import_module(name)
    except ImportError:
        return False
    return True


def cli_in_process(main, argv: list[str]) -> dict:
    """A CLI's ``main(argv)`` in this process, its JSON report parsed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def replay_rows(out: pathlib.Path) -> tuple[list, list]:
    """(rows without their stamp, the stamps) of a run's detections.jsonl."""
    rows = [json.loads(line) for line in open(out / "detections.jsonl")]
    return [{k: v for k, v in r.items() if k != "ts"} for r in rows], [r["ts"] for r in rows]


def read_ms(source) -> float:
    """Host ms a message to read and decode ``source`` (median of passes)."""
    times = []
    for _ in range(REPLAY_READS):
        t0 = time.perf_counter()
        n = sum(1 for _ in source)
        times.append((time.perf_counter() - t0) / max(n, 1))
    return float(np.median(times)) * 1e3


def evaluate_remote(argv: list[str], out: pathlib.Path) -> tuple[dict, list, str]:
    """``evaluate`` as a client process with no card: waits for it to serve
    its Summaries, scrapes ``/metrics`` once, sends SIGINT; returns (its
    report, its rows without stamps, the scrape)."""
    import signal
    import socket
    import threading
    import urllib.request

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "triton_client_tpu_torch", "evaluate", *argv, "--sink", "jsonl",
         "-o", str(out), "--prometheus-port", str(port)],
        cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    watchdog = threading.Timer(600.0, proc.kill)
    watchdog.start()
    try:
        err = []
        for line in proc.stderr:
            err.append(line)
            if "serving eval metrics on" in line:
                break
        check(proc.poll() is None, f"evaluate exited {proc.returncode} before serving: "
              f"{''.join(err)[-3000:]}")
        text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30).read()
        proc.send_signal(signal.SIGINT)
        stdout, rest = proc.communicate(timeout=120)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"evaluate exited {proc.returncode} after SIGINT: {rest[-3000:]}")
    report = json.loads(stdout.strip().splitlines()[-1])
    return report, replay_rows(out)[0], text.decode()


def summaries(exporter_registry) -> list[str]:
    """The five Summaries' _count and _sum samples of a registry, as text."""
    import prometheus_client

    return model_samples(prometheus_client.generate_latest(exporter_registry).decode())


def model_samples(text: str) -> list[str]:
    return sorted(line for line in text.splitlines()
                  if line.startswith("model_") and ("_count " in line or "_sum " in line))


def run_replay(card: str, counters) -> dict:
    """Phase 30 (see the module docstring). Returns the kernels' launches by
    replay path for the ``kernels`` record."""
    import shutil
    import tempfile

    from triton_client_tpu_torch.cli import detect2d as detect2d_cli
    from triton_client_tpu_torch.cli import detect3d as detect3d_cli
    from triton_client_tpu_torch.cli import serve as serve_cli
    from triton_client_tpu_torch.cli import tools
    from triton_client_tpu_torch.eval.detection_map import DetectionEvaluator
    from triton_client_tpu_torch.io import rosbag, synthdata
    from triton_client_tpu_torch.io.bag_io import BagImageSource, BagPointCloudSource
    from triton_client_tpu_torch.io.sources import ImageDirSource, NpyPointCloudSource

    t_phase = time.perf_counter()
    have = {name: optional_package(name) for name in ("cv2", "PIL", "prometheus_client")}
    legs = {"2d": have["cv2"],  # the 2D frames are drawn with cv2
            "images_sink": have["cv2"],
            "evaluate_exporter": have["cv2"] and have["prometheus_client"],
            "3d_kitti": True, "3d_kitti_bz2": True, "3d_bag_sink": True,
            "centerpoint_odom": True}
    emit("replay_legs", card, packages=have, legs=legs,
         missing=[name for name, ok in have.items() if not ok])

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="replay_"))
    cwd = os.getcwd()
    os.chdir(ROOT)  # the entries name data/ files relative to the checkout
    try:
        # -- the bags and the repositories ------------------------------------------------
        t0 = time.perf_counter()
        bags = tmp / "bags"
        bags.mkdir()
        synthdata.write_scene_bag(str(bags / "kitti.bag"), REPLAY_SCANS, seed=30, **REPLAY_KITTI)
        synthdata.write_scene_bag(str(bags / "kitti_bz2.bag"), REPLAY_SCANS, seed=30,
                                  compression="bz2", **REPLAY_KITTI)
        synthdata.write_scene_bag(str(bags / "nusc.bag"), REPLAY_SWEEPS, seed=32,
                                  odom_topic="/odom", **REPLAY_NUSC)
        if legs["2d"]:
            gt = synthdata.write_detection_bag(str(bags / "frames.bag"), REPLAY_FRAMES,
                                               REPLAY_HW, seed=31)
            images_dir, gt_ds = synthdata.write_detection_dataset(
                str(tmp / "frames_ds"), REPLAY_FRAMES, REPLAY_HW, seed=31)
            check(open(gt).read() == open(gt_ds).read(), "the frame bag's GT differs from "
                  "the dataset's")
        write_s = time.perf_counter() - t0
        bag_bytes = {p.name: p.stat().st_size for p in bags.glob("*.bag")}
        root_a, _ = remote_repository(tmp / "a")
        root_b, _, _ = centerpoint_repository(tmp / "b")
        model_2d = f"{REMOTE_2D}_c005"

        # -- host read and decode a message -----------------------------------------------
        for name, spec in (("kitti", "kitti.bag"), ("nusc", "nusc.bag")):
            tools.pc_extract([str(bags / spec), "-o", str(tmp / f"{name}_npy")])
        host_ms = {
            "kitti_bag": read_ms(BagPointCloudSource(str(bags / "kitti.bag"))),
            "kitti_bag_bz2": read_ms(BagPointCloudSource(str(bags / "kitti_bz2.bag"))),
            "kitti_npy": read_ms(NpyPointCloudSource(str(tmp / "kitti_npy"))),
            "nusc_bag": read_ms(BagPointCloudSource(str(bags / "nusc.bag"))),
        }
        if legs["2d"]:
            host_ms["frames_bag"] = read_ms(BagImageSource(str(bags / "frames.bag")))
            host_ms["frames_png_dir"] = read_ms(ImageDirSource(images_dir))
        points = [len(f.data) for f in BagPointCloudSource(str(bags / "kitti.bag"))]
        sweep_points = [len(f.data) for f in BagPointCloudSource(str(bags / "nusc.bag"))]
        widest = max(sum(sweep_points[max(0, i - CP_SWEEPS + 1):i + 1])
                     for i in range(len(sweep_points)))
        check(widest <= 262144, f"{CP_SWEEPS} sweeps hold {widest} points, past the largest "
              "bucket")

        launches, runs, checks = {}, {}, {}

        def launches_per_request(report, names, label, want_calls):
            got = report["kernel_launches"]
            for name in names:
                check(got[name] == want_calls, f"{label}: {name} launched {got[name]} times for "
                      f"{want_calls} requests")
            launches[label] = {name: got[name] for name in names}

        # -- 2D: a bag against an image directory, in-process, --gt -----------------------
        if legs["2d"]:
            common = ["-r", str(root_a), "-m", model_2d]
            rep_bag = cli_in_process(detect2d_cli.main, [*common, "-i", str(bags / "frames.bag"),
                                                         "--gt", gt, "--sink", "jsonl",
                                                         "-o", str(tmp / "2d_bag")])
            rows_bag, stamps = replay_rows(tmp / "2d_bag")
            rep_dir = cli_in_process(detect2d_cli.main, [*common, "-i", images_dir, "--sink",
                                                         "jsonl", "-o", str(tmp / "2d_dir")])
            rows_dir, _ = replay_rows(tmp / "2d_dir")
            check(rows_bag == rows_dir, "detect2d: rows from the bag differ from the image "
                  "directory's")
            check(stamps == [(i + 1) * synthdata.REPLAY_PERIOD for i in range(REPLAY_FRAMES)],
                  f"detect2d: bag frames carry stamps {stamps[:3]}...")
            kept = sum(sum(r["valid"]) for r in rows_bag)
            check(kept > 0, "detect2d kept nothing on the replayed frames")
            ev = DetectionEvaluator()
            table = {json.loads(line)["frame_id"]: json.loads(line)["boxes"] for line in open(gt)}
            for r in rows_bag:
                ev.add_frame(np.asarray(r["detections"], np.float32), np.asarray(r["valid"]),
                             np.asarray(table[r["frame_id"]], np.float64).reshape(-1, 5))
            check(rep_bag["eval"] == json.loads(json.dumps(ev.summary())),
                  f"detect2d --gt: the report's summary {rep_bag['eval']} is not "
                  "eval/detection_map's on its rows")
            for label, rep in (("detect2d_bag", rep_bag), ("detect2d_png_dir", rep_dir)):
                launches_per_request(rep, ("decode_nms_2d",), label,
                                     rep["driver"]["ticks"] + 1)  # and the driver's warmup
            runs["detect2d_bag"] = rep_bag["driver"]
            runs["detect2d_png_dir"] = rep_dir["driver"]
            checks["2d"] = {"frames": REPLAY_FRAMES, "kept": kept, "bag_equals_png_dir": True,
                            "eval": rep_bag["eval"]}
            if legs["images_sink"]:
                from triton_client_tpu_torch.io.draw import draw_boxes

                cli_in_process(detect2d_cli.main, [*common, "-i", str(bags / "frames.bag"),
                                                   "--sink", "images", "-o", str(tmp / "pngs")])
                names = tuple(load_names_of(root_a / model_2d))
                for frame, row in zip(BagImageSource(str(bags / "frames.bag")), rows_bag):
                    png = read_png(tmp / "pngs" / f"{frame.frame_id:04d}.png")
                    want = draw_boxes(frame.data, np.asarray(row["detections"], np.float32),
                                      np.asarray(row["valid"]), names)
                    check(png.tobytes() == want.tobytes(),
                          f"--sink images: frame {frame.frame_id}'s PNG is not its rows drawn")
                checks["images_sink"] = {"pngs": REPLAY_FRAMES, "equal_rows_drawn": True}

            # -- 2D as a remote client of serve, with no card ------------------------------
            args = serve_cli.parser().parse_args(
                ["-r", str(_only(root_a, model_2d, tmp / "served")), "-a", "127.0.0.1:0",
                 "--uds", "off", "--warmup", "--max-workers", "4"])
            server = serve_cli.build_server(args)
            repo = server.servicer._repo
            repo.get(model_2d).infer_fn({"images": torch.zeros((1, *REPLAY_HW, 3),
                                                               dtype=torch.uint8, device="cuda")})
            torch.cuda.synchronize()
            server.start()
            try:
                captures = repo.get(model_2d).infer_fn.graph_stats()["captures"]
                for counter in counters:
                    counter.reset()
                remote_argv = ["-u", f"grpc:127.0.0.1:{server.port}", "-m", model_2d,
                               "-i", str(bags / "frames.bag"), "--gt", gt]
                if legs["evaluate_exporter"]:
                    import prometheus_client

                    from triton_client_tpu_torch.eval.prometheus_export import (
                        EvalPrometheusExporter,
                    )

                    rep_remote, rows_remote, scrape = evaluate_remote(remote_argv,
                                                                      tmp / "2d_remote")
                    want_exporter = EvalPrometheusExporter.into(
                        prometheus_client.CollectorRegistry())
                    for frame_stats in ev.per_frame_summaries():
                        want_exporter.observe(*frame_stats)
                    got_samples = model_samples(scrape)
                    check(got_samples == summaries(want_exporter.registry) and got_samples,
                          f"evaluate's Summaries {got_samples[:4]} are not detection_map's")
                    checks["evaluate_exporter"] = {"samples": len(got_samples),
                                                   "equal_detection_map": True}
                else:
                    rep_remote, rows_remote = client_run("detect2d", remote_argv,
                                                         tmp / "2d_remote", True)
                torch.cuda.synchronize()
                served_calls = rep_remote["driver"]["ticks"] + 1
                check(counters[0].count == served_calls,
                      f"serve launched decode_nms_2d {counters[0].count} times for "
                      f"{served_calls} requests")
                launches["detect2d_bag_remote"] = {"decode_nms_2d": counters[0].count}
                check(repo.get(model_2d).infer_fn.graph_stats()["captures"] == captures,
                      "a remote request captured a graph inside the counted window")
            finally:
                server.stop()
            check(rows_remote == rows_bag, "the remote client's rows from the bag differ from "
                  "the in-process run's")
            check(rep_remote["eval"] == rep_bag["eval"], "the remote summary differs")
            runs["detect2d_bag_remote"] = rep_remote["driver"]

        # -- KITTI PointPillars: a bag, the same bag in bz2 chunks, the clouds pc-extract
        # wrote of it, and the output bag ----------------------------------------------------
        common = ["-r", str(root_a), "-m", REMOTE_3D]
        rows_3d = {}
        for label, spec in (("bag", bags / "kitti.bag"), ("bag_bz2", bags / "kitti_bz2.bag"),
                            ("npy", tmp / "kitti_npy")):
            rep = cli_in_process(detect3d_cli.main, [*common, "-i", str(spec), "--sink",
                                                     "jsonl", "-o", str(tmp / f"3d_{label}")])
            rows_3d[label] = replay_rows(tmp / f"3d_{label}")[0]
            launches_per_request(rep, ("residual_decode_3d", "suppress_pack_3d"),
                                 f"detect3d_{label}", rep["driver"]["ticks"] + 1)
            runs[f"detect3d_{label}"] = rep["driver"]
        check(rows_3d["bag"] == rows_3d["npy"] == rows_3d["bag_bz2"],
              "detect3d: rows from the bag, its bz2 copy and its .npy clouds differ")
        dets_3d = sum(len(r["pred_scores"]) for r in rows_3d["bag"])
        check(dets_3d > 0, "detect3d kept nothing on the replayed scans")
        cli_in_process(detect3d_cli.main, [*common, "-i", str(bags / "kitti.bag"), "--sink", "bag",
                                           "-o", str(tmp / "3d_out")])
        with rosbag.BagReader(str(tmp / "3d_out" / "kitti.bag_output.bag")) as r:
            arrays = [m for _, m, _ in r.read_messages(topics=["/tpu_detections/boxes3d"])]
            clouds_out = [rosbag.pointcloud2_to_xyzi(m)
                          for _, m, _ in r.read_messages(topics=["/points"])]
        check(len(arrays) == len(clouds_out) == REPLAY_SCANS, "the output bag's message count")
        for arr, row, cloud, frame in zip(arrays, rows_3d["bag"], clouds_out,
                                          BagPointCloudSource(str(bags / "kitti.bag"))):
            boxes = np.asarray(row["pred_boxes"], np.float32).reshape(-1, 7)
            got = np.asarray([[b.pose.position.x, b.pose.position.y, b.pose.position.z,
                               b.dimensions.y, b.dimensions.x, b.dimensions.z]
                              for b in arr.boxes], np.float32).reshape(-1, 6)
            check(got.tobytes() == boxes[:, :6].tobytes()
                  and [b.label for b in arr.boxes] == row["pred_labels"]
                  and [np.float32(b.value) for b in arr.boxes]
                  == [np.float32(v) for v in row["pred_scores"]],
                  f"the output bag's boxes of scan {frame.frame_id} are not its rows'")
            check(cloud.tobytes() == frame.data.tobytes(), "the output bag's cloud differs")
        checks["3d_kitti"] = {"scans": REPLAY_SCANS, "detections": dets_3d,
                              "bag_equals_npy_and_bz2": True, "output_bag_equals_rows": True}

        # -- CenterPoint: 10 sweeps posed by the bag's odometry, against the clouds and
        # the pose file at the bag's period ------------------------------------------------
        common = ["-r", str(root_b), "-m", CP_ENTRY, "--sweeps", str(CP_SWEEPS), "--sink",
                  "jsonl"]
        rep_cp = cli_in_process(detect3d_cli.main, [*common, "-i", str(bags / "nusc.bag"),
                                                    "--poses", "odom", "-o", str(tmp / "cp_bag")])
        rep_cp_npy = cli_in_process(detect3d_cli.main, [
            *common, "-i", str(tmp / "nusc_npy"), "--poses", str(bags / "nusc.bag.poses.jsonl"),
            "--scan-period", str(synthdata.REPLAY_PERIOD), "-o", str(tmp / "cp_npy")])
        rows_cp, rows_cp_npy = (replay_rows(tmp / d)[0] for d in ("cp_bag", "cp_npy"))
        check(rows_cp == rows_cp_npy, "CenterPoint --poses odom: rows from the bag differ from "
              "the .npy clouds' with the pose file")
        check(rep_cp["sweeps"] == CP_SWEEPS and all(len(r["pred_velocities"]) ==
                                                    len(r["pred_scores"]) for r in rows_cp),
              "CenterPoint rows without velocities")
        dets_cp = sum(len(r["pred_scores"]) for r in rows_cp)
        check(dets_cp > 0, "CenterPoint kept nothing on the replayed sweeps")
        for label, rep in (("centerpoint_bag_odom", rep_cp), ("centerpoint_npy_poses",
                                                              rep_cp_npy)):
            launches_per_request(rep, ("suppress_pack_3d",), label, rep["driver"]["ticks"] + 1)
            runs[label] = rep["driver"]
        checks["centerpoint_odom"] = {"scans": REPLAY_SWEEPS, "detections": dets_cp,
                                      "bag_odom_equals_npy_pose_file": True}
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp)
        torch.cuda.empty_cache()

    rates = {label: {"per_s": r["fps"], "p50_ms": r["p50_ms"], "frames": r["frames"]}
             for label, r in runs.items()}
    emit("replay", card, bag_bytes=bag_bytes, write_s=write_s, scan_points=points,
         sweep_points=sweep_points, widest_aggregate=widest, period_s=synthdata.REPLAY_PERIOD, checks=checks,
         launches=launches, rates=rates, host_read_decode_ms_per_message=host_ms,
         wall_s=time.perf_counter() - t_phase)
    return launches


# phase 31: the detectron family and YOLOv4 from disk. The low-conf copy's
# threshold: seeded YOLOv4 heads put obj * cls at ~0.25 (under the entry's
# 0.4, over 0.2 on all 16,128 predictions); RetinaNet and FCOS fill K at
# their entries' 0.05 (raw pixels drive a seeded class output far past its
# prior)
DV4_ENTRIES = ("yolov4_coco", "retinanet_coco", "fcos_crop")
DV4_COPIES = {"yolov4_coco_c02": ("yolov4_coco", 0.2)}
DV4_REQUESTS, DV4_REMOTE_FRAMES, DV4_BATCH = 20, 8, 4
DV4_SCORED = (4, 1024, 100, 80)  # kernel 1's scored shape: B, K, max_det, classes
DV4_PAIRS = 57600 * 80  # RetinaNet's (anchor, class) pairs a 480x640 frame


def forward_gflops(model, x) -> float:
    """GFLOPs (2 x multiply-adds of the convolutions and matrix products,
    ``torch.utils.flop_counter``) of one forward on ``x``, per frame; the
    float32 heads' functional convolutions count too."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x)
    return counter.get_total_flops() / x.shape[0] / 1e9


def upstream_state(family: str, seed: int) -> dict:
    """A seeded checkpoint under the upstream names: pytorch-YOLOv4's (its
    SPP merge conv's input blocks in upstream's [p13, p9, p5, x] order) or
    detectron2's (under a ``model.`` prefix), drawn as flax initialises the
    JAX models."""
    from triton_client_tpu_torch.models.layers import init_random_
    from triton_client_tpu_torch.models.retinanet import RetinaNet
    from triton_client_tpu_torch.models.yolov4 import YoloV4
    from triton_client_tpu_torch.runtime import importers

    if family == "yolov4":
        state = {k: v for k, v in init_random_(YoloV4(num_classes=80), seed).state_dict().items()
                 if not k.endswith("num_batches_tracked")}
        state["spp.merge.conv.weight"] = importers.spp_blocks_reversed(
            state["spp.merge.conv.weight"])
        return {importers.yolov4_torch_key(k): v for k, v in state.items()}
    model = init_random_(RetinaNet(num_classes=80), seed)
    model.head.init_prior_()
    return {f"model.{importers.detectron_torch_key(k)}": v
            for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}


def detectron_v4_repository(tmp: pathlib.Path) -> tuple[pathlib.Path, dict]:
    """The phase-31 repository root, and each checkpoint written."""
    root = tmp / "repo"
    states = {"yolov4_coco": upstream_state("yolov4", 31),
              "retinanet_coco": upstream_state("retinanet", 31)}
    for name in DV4_ENTRIES:
        (root / name).mkdir(parents=True)
        (root / name / "config.yaml").write_bytes(
            (ROOT / "examples" / name / "config.yaml").read_bytes())
    for name, (base, conf) in DV4_COPIES.items():
        text = (ROOT / "examples" / base / "config.yaml").read_text()
        line = "  class_names_file: data/coco.names\n"
        check(line in text and "conf_thresh" not in text, f"examples/{base} changed")
        (root / name).mkdir(parents=True)
        (root / name / "config.yaml").write_text(
            text.replace(line, f"{line}  conf_thresh: {conf}\n"))
        states[name] = states[base]
    for name, state in states.items():  # fcos_crop keeps the seeded weights of its scan
        (root / name / "1").mkdir()
        torch.save(state, root / name / "1" / "weights.pth")
    return root, states


def rows_of(out: dict) -> dict:
    """A response in the YOLO contract's terms: rows (B, max_det, 6), valid."""
    if "detections" in out:
        return {"rows": np.asarray(out["detections"]), "valid": np.asarray(out["valid"])}
    rows = np.concatenate([np.asarray(out["boxes"]), np.asarray(out["scores"])[..., None],
                           np.asarray(out["classes"], np.float32)[..., None]], -1)
    valid = np.arange(rows.shape[1])[None] < np.asarray(out["dims"])[:, None]
    return {"rows": rows, "valid": valid}


def rows_vs_cpu(card: dict, cpu: dict) -> dict:
    """The card's rows against the CPU port's on the same frames and
    weights: kept counts, labels in order, the largest score difference and
    the largest box difference over the box's largest coordinate."""
    g, c = rows_of(card), rows_of(cpu)
    same_valid = bool(np.array_equal(g["valid"], c["valid"]))
    out = {"kept": int(g["valid"].sum()), "kept_cpu": int(c["valid"].sum()),
           "valid_equal": same_valid}
    if same_valid:
        gv, cv = g["rows"][g["valid"]], c["rows"][c["valid"]]
        out.update(labels_equal=bool(np.array_equal(gv[:, 5], cv[:, 5])),
                   max_score_err=float(np.abs(gv[:, 4] - cv[:, 4]).max(initial=0.0)),
                   max_box_err_rel=box_err_rel(gv[:, :4], cv[:, :4]))
    return out


# the card against the CPU port, at the parity tests' bars against JAX
# (tests/test_torch_retinanet.py, test_torch_yolov4.py): heads within 1e-5
# of the largest head value; rows' scores within 2e-5 and boxes within 5e-5
# of the box's largest coordinate
DV4_HEAD_BAR, DV4_SCORE_BAR, DV4_BOX_BAR = 1e-5, 2e-5, 5e-5


def raw_heads(pipe, frames: torch.Tensor) -> list:
    """A 2D pipeline's model outputs, float32, on ``frames``, as its body
    computes them (``Detect2DPipeline.run`` up to the decode)."""
    from triton_client_tpu_torch.ops.preprocess import normalize_image, resize_bilinear

    cfg = pipe.config
    with torch.no_grad():
        x = pipe.precision.cast_in(pipe.precision.ingest({"images": frames})["images"])
        if tuple(x.shape[1:3]) != tuple(cfg.input_hw):
            x = resize_bilinear(x, cfg.input_hw)
        return list(_model_of(pipe)(normalize_image(x, cfg.scaling)))


def box_err_rel(got: np.ndarray, want: np.ndarray) -> float:
    """The largest box difference over its box's largest coordinate (at
    least 1): the decode's ``exp`` spreads an ulp of a head value over the
    whole box."""
    scale = np.maximum(np.abs(want).max(-1, keepdims=True), 1.0)
    return float((np.abs(got - want) / scale).max(initial=0.0))


def run_detectron_v4(card: str, counters) -> dict:
    """Phase 31 (see the module docstring). Returns kernel 1's launches by
    entry and its scored-shape times for the ``kernels`` record."""
    import shutil
    import tempfile

    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.channel.kserve import codec, pb, service
    from triton_client_tpu_torch.cli import detect2d as detect2d_cli
    from triton_client_tpu_torch.io.sources import SyntheticImageSource
    from triton_client_tpu_torch.ops import gpu_decode, kernel_cases
    from triton_client_tpu_torch.ops.detect_postprocess import stable_top_k
    from triton_client_tpu_torch.ops.nms import class_offset_boxes
    from triton_client_tpu_torch.ops.preprocess import normalize_image, resize_bilinear
    from triton_client_tpu_torch.runtime.disk_repository import scan_disk
    from triton_client_tpu_torch.runtime.server import InferenceServer, _Servicer

    t_phase = time.perf_counter()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="detectron_v4_"))
    cwd = os.getcwd()
    os.chdir(ROOT)  # the entries name data/ files relative to the checkout
    try:
        t0 = time.perf_counter()
        root, _ = detectron_v4_repository(tmp)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        repo = scan_disk(root)
        for name, version in repo.list_models():
            repo.get(name, version).warmup()
        build_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    names = sorted(repo.names())
    check(names == sorted(DV4_ENTRIES + tuple(DV4_COPIES)), f"scanned {names}")
    for name in names:
        spec = repo.metadata(name)
        check(spec.extra["fused_stages"] == ["decode_nms"], f"{name}: not fused on the card")
    for name in ("retinanet_coco", "fcos_crop"):
        check([(t.name, t.dtype) for t in repo.metadata(name).outputs] ==
              [("boxes", "FP32"), ("scores", "FP32"), ("classes", "INT64"), ("dims", "INT32")],
              f"{name} does not serve the detectron contract")
    channel = CUDAChannel(repo)
    servicer = _Servicer(repo, channel, stream_pipeline_depth=2)
    frames = np.stack([f.data for f in SyntheticImageSource(8, FRAME_HW, seed=31)])
    b1, b4 = frames[:1].astype(np.float32), frames[1:1 + DV4_BATCH].astype(np.float32)
    pipes = {name: pipeline_of(repo.get(name)) for name in names}

    # -- GFLOPs a frame -------------------------------------------------------------------------
    gflops = {}
    for name in DV4_ENTRIES:
        pipe = pipes[name]
        x = torch.zeros((1, *pipe.config.input_hw, 3), device="cuda")
        gflops[name] = forward_gflops(_model_of(pipe), x)

    def through_servicer(model, inputs):
        payload = codec.build_infer_request(model, inputs)
        return codec.parse_infer_response(pb.ModelInferResponse.FromString(
            service.invoke(servicer, "ModelInfer", payload.SerializeToString())))

    # -- kernel 1 on each path's own candidates; captured against eager ------------------------
    candidates = {}
    for name in names:
        pipe = pipes[name]
        x = torch.from_numpy(b4).cuda()
        _, calls = recorded_kernel_calls(lambda: pipe.run(x))
        check(len(calls.get("decode_nms_2d", ())) == 1, f"{name}: kernel 1 not on the path")
        kernels_equal_plain(calls, name)
        (args, kw), = calls["decode_nms_2d"]
        candidates[name] = {"shape": list(args[0].shape), "live": int(args[3].sum()),
                            "box_format": kw["box_format"], "max_det": kw["max_det"],
                            "max_abs_coord": float(args[0][args[3]].abs().max())
                            if bool(args[3].any()) else 0.0}
        a, b = (torch.from_numpy(frames[i:i + 1].astype(np.float32)).cuda() for i in (0, 5))
        if name == "yolov4_coco":  # nothing over 0.4: one input shows the bodies equal
            got, want = pipe._jit(a), pipe.run(a)
            torch.cuda.synchronize()
            check(outputs_bitwise_equal(got, want), f"{name}: the captured call differs")
        else:
            hold_captured_to_eager(pipe, (a,), (b,), counters, name)
    for name in ("retinanet_coco", "fcos_crop", "yolov4_coco_c02"):
        check(candidates[name]["live"] == DV4_BATCH * 1024,
              f"{name}: {candidates[name]['live']} live candidates, want a full K")

    # -- requests, then the counted window ------------------------------------------------------
    requests = {f"{name}_b{len(x)}": (name, {"images": x}) for name in names for x in (b1, b4)}
    direct = {label: channel.do_inference(InferRequest(m, x)).outputs
              for label, (m, x) in requests.items()}
    for m, x in requests.values():  # any capture happens here, outside the window
        through_servicer(m, x)
    torch.cuda.synchronize()
    captures = {n: repo.get(n).infer_fn.graph_stats()["captures"] for n in names}
    launches = {}
    got = {}
    for name in names:
        for counter in counters:
            counter.reset()
        for label, (m, x) in requests.items():
            if m == name:
                got[label] = through_servicer(m, x)
        torch.cuda.synchronize()
        counts = dict(zip(COUNTER_NAMES, (c.count for c in counters)))
        check(counts == {**{k: 0 for k in COUNTER_NAMES}, "decode_nms_2d": 2},
              f"{name}: launches {counts} for 2 requests, want kernel 1 twice and nothing else")
        launches[name] = counts["decode_nms_2d"]
    check({n: repo.get(n).infer_fn.graph_stats()["captures"] for n in names} == captures,
          "a request captured a graph inside the counted window")
    for label, out in got.items():
        want = direct[label]
        check(sorted(out) == sorted(want), f"{label}: outputs {sorted(out)}")
        for key in want:
            check(out[key].dtype == want[key].dtype and out[key].tobytes() == want[key].tobytes(),
                  f"{label}: {key} through the servicer differs from CUDAChannel.do_inference")
        if "dims" in out:
            check(out["classes"].dtype == np.int64 and out["dims"].dtype == np.int32,
                  f"{label}: classes {out['classes'].dtype}, dims {out['dims'].dtype}")
        check(bool(np.isfinite(rows_of(out)["rows"]).all()), f"{label}: rows not finite")
    kept = {label: int(rows_of(out)["valid"].sum()) for label, out in got.items()}

    # -- the card against the CPU port, on the same weights -------------------------------------
    t0 = time.perf_counter()
    os.chdir(ROOT)
    try:
        cpu_repo = scan_disk(root, device="cpu")
    finally:
        os.chdir(cwd)
    vs_cpu = {}
    for name in names:
        cpu_pipe = pipeline_of(cpu_repo.get(name))
        cpu_out = cpu_repo.get(name).infer_fn({"images": torch.from_numpy(b1)})
        vs_cpu[name] = rows_vs_cpu(direct[f"{name}_b1"], {k: v.numpy() for k, v in cpu_out.items()})
        heads = [[t.cpu().numpy() for t in raw_heads(p, torch.from_numpy(b1).to(d))]
                 for p, d in ((pipes[name], "cuda"), (cpu_pipe, "cpu"))]
        vs_cpu[name]["heads_err_of_max"] = max(float(np.abs(g - c).max() / np.abs(c).max())
                                               for g, c in zip(*heads))
        check(vs_cpu[name]["heads_err_of_max"] <= DV4_HEAD_BAR,
              f"{name}: the card's heads against the CPU's: {vs_cpu[name]}")
        rows = vs_cpu[name]
        check(rows["kept"] == rows["kept_cpu"], f"{name}: the card and the CPU keep {rows}")
        if name.startswith("yolov4"):
            # seeded YOLOv4 scores sit within ~1e-4 of 0.25 over 16,128 boxes, far
            # closer together than the card's heads differ from the CPU's: the
            # top-k order, and so the rows, follow each device's rounding (the
            # tails are held to their plain versions here, to JAX on the CPU)
            continue
        check(rows["valid_equal"] and rows["labels_equal"]
              and rows["max_score_err"] <= DV4_SCORE_BAR
              and rows["max_box_err_rel"] <= DV4_BOX_BAR,
              f"{name}: the card's rows against the CPU's: {rows}")
    del cpu_repo
    cpu_s = time.perf_counter() - t0

    # -- a remote client of the YOLOv4 copy, against the in-process -r run ---------------------
    model_v4 = "yolov4_coco_c02"
    repo.get(model_v4).infer_fn({"images": torch.zeros((1, *FRAME_HW, 3), dtype=torch.uint8,
                                                      device="cuda")})  # the client's key
    server = InferenceServer(repo, channel, address="127.0.0.1:0")
    server.start()
    try:
        argv = ["-m", model_v4, "-i", f"synthetic:{DV4_REMOTE_FRAMES}:{FRAME_HW[0]}x{FRAME_HW[1]}"]
        os.chdir(ROOT)  # the entry names data/coco.names relative to the checkout
        try:
            local = cli_in_process(detect2d_cli.main, [*argv, "-r", str(root), "--sink", "jsonl",
                                                       "-o", str(tmp / "local")])
        finally:
            os.chdir(cwd)
        for counter in counters:
            counter.reset()
        report, rows = client_run("detect2d", [*argv, "-u", f"grpc:127.0.0.1:{server.port}"],
                                  tmp / "remote", True)
        torch.cuda.synchronize()
        remote_launches = gpu_decode.launches.count
    finally:
        server.stop()
    local_rows, _ = replay_rows(tmp / "local")
    check(rows == local_rows, "detect2d -u grpc: rows differ from the in-process -r run")
    check(report["frames"] == local["frames"] == DV4_REMOTE_FRAMES, f"remote report {report}")
    check(remote_launches == DV4_REMOTE_FRAMES + 1,  # the client's warmup request too
          f"the server launched kernel 1 {remote_launches} times for "
          f"{DV4_REMOTE_FRAMES + 1} remote requests")

    # -- times ------------------------------------------------------------------------------------
    times, profiles = {}, {}
    for name in names:
        for x in (b1, b4):
            req = InferRequest(name, {"images": x})
            times[f"{name}_b{len(x)}"] = serve(lambda _x, r=req: channel.do_inference(r), [None],
                                               DV4_REQUESTS, "frames_per_s", lambda _x, n=len(x): n)
    for name in DV4_ENTRIES + tuple(DV4_COPIES):
        req = InferRequest(name, {"images": b1})
        profiles[name] = device_profile(lambda r=req: channel.do_inference(r), PROFILE_REQUESTS)
    b, k, max_det, nc = DV4_SCORED
    args = [torch.from_numpy(a).cuda() for a in kernel_cases.scored_candidates(b, k, nc, seed=31)]
    kw = dict(iou_thresh=0.5, max_det=max_det, box_format="xyxy", class_agnostic=False)
    rows_k, keep = gpu_decode.fused_decode_nms_2d(*args, **kw)
    want_rows, want_keep = gpu_decode.decode_nms_2d_reference(*args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(bits(rows_k), bits(want_rows)) and torch.equal(keep, want_keep),
          "kernel 1 differs from its plain version at the scored shape")
    k1_ms = kernel_device_ms(lambda: gpu_decode.fused_decode_nms_2d(*args, **kw),
                             gpu_decode.launches)
    k1_call_ms = cuda_ms(lambda: gpu_decode.fused_decode_nms_2d(*args, **kw), reps=100)
    k1_plain_ms = cuda_ms(lambda: gpu_decode.decode_nms_2d_reference(*args, **kw), reps=3,
                          warmup=1)
    offset = class_offset_boxes(args[0], args[2])
    masked = torch.where(args[3], args[1], float("-inf"))
    iou_tests = live_counts(offset, masked, torch.tensor(0.5, device="cuda"), max_det)
    k1_bound, k1_by = roofline(b * k * (16 + 4 + 4 + 1) + b * max_det * (24 + 1),
                               iou_tests * IOU_OPS)
    sort_ms = {}
    gen = torch.Generator(device="cuda").manual_seed(31)
    for batch in (1, DV4_BATCH):
        x = torch.rand((batch, DV4_PAIRS), device="cuda", generator=gen)
        sort_ms[f"{batch * DV4_PAIRS}"] = cuda_ms(lambda x=x: stable_top_k(x, 1024), reps=20)
    scored_shape = {"shape": [b, k, max_det], "classes": nc, "box_format": "xyxy",
                    "ms": k1_ms, "call_ms": k1_call_ms, "plain_ms": k1_plain_ms,
                    "bound_ms": k1_bound, "bound_by": k1_by, "iou_tests": iou_tests,
                    "kept": int(keep.sum()), "match": True}
    emit("detectron_v4_kernel", card, decode_nms_2d=scored_shape,
         stable_sort_ms_by_entries=sort_ms)
    pool_bytes = {n: repo.get(n).infer_fn.graph_stats()["pool_bytes"] for n in names}
    param_bytes = {n: repo.metadata(n).extra["param_bytes"] for n in names}
    emit("detectron_v4", card, entries=names, low_conf_copies=DV4_COPIES, write_s=write_s,
         build_and_capture_s=build_s, gflops_per_frame=gflops, candidates=candidates,
         launches=launches, kept=kept, bitwise_servicer_channel=True, captured_equals_eager=True,
         card_vs_cpu=vs_cpu, card_vs_cpu_s=cpu_s,
         remote={"model": model_v4, "frames": DV4_REMOTE_FRAMES, "rows_equal_in_process": True,
                 "transport": report["transport"], "server_launches": remote_launches},
         times=times, profiles=profiles, graph_pool_bytes=pool_bytes, param_bytes=param_bytes,
         wall_s=time.perf_counter() - t_phase)
    del repo, channel, servicer, pipes, server
    torch.cuda.empty_cache()
    shutil.rmtree(tmp)
    return {"launches": launches, "scored_shape": scored_shape}


def _model_of(pipe):
    """The model a 2D pipeline's forward closes over."""
    return next(c.cell_contents for c in pipe._forward.__closure__
                if isinstance(c.cell_contents, torch.nn.Module))


def load_names_of(entry: pathlib.Path) -> list[str]:
    """A repository entry's class names (its config's class_names_file)."""
    from triton_client_tpu_torch.dataset_config import load_yaml
    from triton_client_tpu_torch.pipelines.detect2d import load_class_names

    doc = load_yaml(str(entry / "config.yaml"))
    path = (doc.get("pipeline") or {}).get("class_names_file") or doc.get("class_names_file")
    return list(load_class_names(path)) if path else []


def read_png(path: pathlib.Path) -> np.ndarray:
    """A PNG's RGB pixels (cv2 where installed, else PIL)."""
    try:
        import cv2
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))
    return cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]



# phase 32: server-side preprocess and ensembles. The examples/ entries that
# chain them, yolov5_crop at conf 0.05 (its seeded weights keep nothing at
# 0.3, as phase 27's copy), and a fuse: never copy of the fused ensemble
ENSEMBLE_ENTRIES = ("camera_preprocess", "yolov5_crop", "yolov5_crop_base",
                    "ensemble_crop_pipeline", "ensemble_fused_pipeline")
ENSEMBLE_HOST = "ensemble_fused_never"
ENSEMBLE_BATCHES = 4  # requests a batch size (1 and 8) in the counted window
ENSEMBLE_REQUESTS = 20  # requests a timed path at batch 1 (batch 8: half)


def ensemble_repository(tmp: pathlib.Path) -> pathlib.Path:
    """The phase-32 repository root (configs only; data/ resolves from the
    checkout, the working directory)."""
    for name in ENSEMBLE_ENTRIES:
        (tmp / name).mkdir()
        (tmp / name / "config.yaml").write_bytes(
            (ROOT / "examples" / name / "config.yaml").read_bytes())
    crop = (tmp / "yolov5_crop" / "config.yaml").read_text()
    check("conf_thresh: 0.3" in crop, "examples/yolov5_crop changed its conf_thresh")
    (tmp / "yolov5_crop" / "config.yaml").write_text(
        crop.replace("conf_thresh: 0.3", "conf_thresh: 0.05"))
    fused = (tmp / "ensemble_fused_pipeline" / "config.yaml").read_text()
    check("fuse: always" in fused, "examples/ensemble_fused_pipeline is not fuse: always")
    (tmp / ENSEMBLE_HOST).mkdir()
    (tmp / ENSEMBLE_HOST / "config.yaml").write_text(fused.replace("fuse: always",
                                                                     "fuse: never"))
    return tmp


def run_ensemble(card: str, counters) -> int:
    """Phase 32: ``scan_disk`` of the ensemble repository on the card, served
    by ``CUDAChannel``: the fused DAG (preprocess -> yolov5_crop, one graph
    over both pipelines), its host path (``fuse: never``: each step's
    outputs read back, then uploaded again), the chain run by hand (each
    entry through the channel), ``ensemble_crop_pipeline`` on the
    preprocessed frames, and a device-resident DAG (the fused ensemble, then
    a host-only member registered here) on seeded 480x640 camera frames at
    batch 1 and 8. Holds their rows bitwise equal, one kernel-1 launch a
    fused request (through graph replays) and no other kernel, no capture in
    the counted window. Reports p50, frames/s and device ms a request,
    host-device bytes a request and graph-pool bytes of each path, and the
    fused warmup's nominal 64x64 graph. Returns the counted kernel-1
    launches."""
    import tempfile

    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.config import ModelSpec, TensorSpec
    from triton_client_tpu_torch.io.sources import SyntheticImageSource
    from triton_client_tpu_torch.ops import gpu_decode
    from triton_client_tpu_torch.runtime.disk_repository import scan_disk
    from triton_client_tpu_torch.runtime.ensemble import EnsembleStep, build_ensemble

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ensemble_repo_") as tmp:
        repo = scan_disk(ensemble_repository(pathlib.Path(tmp)))
    fused_rm = repo.get("ensemble_fused_pipeline")
    paths_of = {name: repo.get(name).spec.extra["data_path"]
                for name in ("ensemble_fused_pipeline", ENSEMBLE_HOST, "ensemble_crop_pipeline")}
    check(paths_of == {"ensemble_fused_pipeline": "fused", ENSEMBLE_HOST: "host",
                       "ensemble_crop_pipeline": "host"}, f"data paths {paths_of}")
    check(fused_rm.device_fn is not None, "the fused ensemble registered no device form")
    for name in ("camera_preprocess", "yolov5_crop", "yolov5_crop_base"):
        check(repo.get(name).device_fn is None and repo.get(name).member_device_fn is not None,
              f"{name}: the plain entry's route changed")
    # the mixed DAG: the fused ensemble, then a host-only member
    max_det = fused_rm.spec.outputs[1].shape[1]
    repo.register(ModelSpec("valid_count", inputs=(TensorSpec("valid", (-1, max_det), "BOOL"),),
                             outputs=(TensorSpec("count", (-1,), "INT32"),), max_batch_size=8),
                  lambda inputs: {"count": inputs["valid"].sum(-1).to(torch.int32)})
    mixed = build_ensemble(
        repo, "ensemble_mixed",
        [EnsembleStep("ensemble_fused_pipeline", {"camera_raw": "camera_raw"},
                      {"boxes": "boxes", "valid": "valid"}),
         EnsembleStep("valid_count", {"valid": "valid"}, {"count": "count"})],
        outputs=["boxes", "valid", "count"], max_batch_size=8)
    check(mixed.spec.extra["data_path"] == "device-resident",
          f"the mixed DAG's data path is {mixed.spec.extra['data_path']}")
    repo.register(mixed.spec, mixed.infer_fn, warmup=mixed.warmup)
    channel = CUDAChannel(repo)

    frames = np.stack([f.data for f in SyntheticImageSource(4 + 8 * ENSEMBLE_BATCHES, FRAME_HW,
                                                            seed=32)])
    b1 = [frames[i:i + 1] for i in range(ENSEMBLE_BATCHES)]
    b8 = [frames[4 + 8 * i: 12 + 8 * i] for i in range(ENSEMBLE_BATCHES)]

    def ask(name, inputs):
        return channel.do_inference(InferRequest(name, inputs)).outputs

    def hand(batch):
        pre = ask("camera_preprocess", {"images": batch})["preprocessed"]
        out = ask("yolov5_crop", {"images": pre})
        return {"boxes": out["detections"], "valid": out["valid"]}

    paths = {"fused": lambda b: ask("ensemble_fused_pipeline", {"camera_raw": b}),
             "host": lambda b: ask(ENSEMBLE_HOST, {"camera_raw": b}),
             "hand_chain": hand}
    # every graph the window and the timed paths use, captured before them
    for batch in (b1[0], b8[0]):
        for run in paths.values():
            run(batch)
        ask("ensemble_mixed", {"camera_raw": batch})
    launcher = channel._launch_cache[("ensemble_fused_pipeline", "1")][1]
    before = launcher.graphs.stats()
    torch.cuda.synchronize()
    for counter in counters:
        counter.reset()
    fused = [paths["fused"](b) for b in b1 + b8]
    torch.cuda.synchronize()
    counts = dict(zip(COUNTER_NAMES, (c.count for c in counters)))
    after = launcher.graphs.stats()
    n_fused = len(fused)
    k1 = gpu_decode.launches.count
    check(k1 == n_fused and sum(c.count for c in counters[:-1]) == n_fused,
          f"{n_fused} fused requests launched {counts}")
    check(after["captures"] == before["captures"], "a fused request captured in the window")
    check(after["replays"] - before["replays"] == n_fused,
          f"{after['replays'] - before['replays']} replays for {n_fused} fused requests")

    kept = 0
    for i, batch in enumerate(b1 + b8):
        want = fused[i]
        n = batch.shape[0]
        check(want["boxes"].shape == (n, max_det, 6) and want["valid"].shape == (n, max_det),
              f"fused shapes {want['boxes'].shape}")
        check(bool(np.isfinite(want["boxes"]).all()), "non-finite fused rows")
        pre = ask("camera_preprocess", {"images": batch})["preprocessed"]
        others = {"host": paths["host"](batch), "hand_chain": hand(batch),
                  "ensemble_crop_pipeline": ask("ensemble_crop_pipeline", {"camera": pre}),
                  "mixed": ask("ensemble_mixed", {"camera_raw": batch})}
        for label, got in others.items():
            check(np.array_equal(got["valid"], want["valid"]),
                  f"{label}: valid differs from the fused path (request {i})")
            check(np.array_equal(got["boxes"].view(np.int32), want["boxes"].view(np.int32)),
                  f"{label}: rows differ from the fused path (request {i})")
        check(np.array_equal(others["mixed"]["count"], want["valid"].sum(-1)),
              "the host-only member's counts differ")
        kept += int(want["valid"].sum())
    check(kept > 0, "the fused path kept no detection")

    # times, bytes and pools of each path
    host_rm = repo.get(ENSEMBLE_HOST)
    out_hw = repo.get("camera_preprocess").spec.extra["out_hw"]
    report = {}
    for label, run in paths.items():
        row = {}
        for name, batches, reps in (("batch1", b1, ENSEMBLE_REQUESTS),
                                    ("batch8", b8, ENSEMBLE_REQUESTS // 2)):
            timed = serve(run, batches, reps, "frames_per_s", lambda b: b.shape[0])
            prof = device_profile(lambda: run(batches[0]), PROFILE_REQUESTS)
            n = batches[0].shape[0]
            frame_bytes = batches[0].nbytes
            out_bytes = n * max_det * (6 * 4 + 1)
            pre_bytes = n * int(np.prod(out_hw)) * 3 * 4
            if label == "fused":
                h2d, d2h = frame_bytes, out_bytes
            elif label == "host":
                t0 = host_rm.infer_fn.transfer_stats()
                run(batches[0])
                t1 = host_rm.infer_fn.transfer_stats()
                # the channel stages the frame; the ensemble's own hops move
                # the rest, its last readback being the outputs'
                h2d = frame_bytes + t1["h2d_bytes"] - t0["h2d_bytes"]
                d2h = t1["d2h_bytes"] - t0["d2h_bytes"]
            else:  # two requests: the frame in, the preprocessed frame out and in again
                h2d, d2h = frame_bytes + pre_bytes, pre_bytes + out_bytes
            row[name] = {**timed, "device_ms_per_request": prof["device_ms_per_request"],
                         "device_busy_share": prof["device_busy_share"],
                         "h2d_bytes_per_request": h2d, "d2h_bytes_per_request": d2h}
        report[label] = row
    pipe_pools = sum(repo.get(name).infer_fn.graph_stats()["pool_bytes"]
                     for name in ("camera_preprocess", "yolov5_crop"))
    report["fused"]["graph_pool_bytes"] = launcher.graphs.stats()["pool_bytes"]
    report["host"]["graph_pool_bytes"] = report["hand_chain"]["graph_pool_bytes"] = pipe_pools
    saved = {b: report["host"][b]["h2d_bytes_per_request"] + report["host"][b][
        "d2h_bytes_per_request"] - report["fused"][b]["h2d_bytes_per_request"] - report[
        "fused"][b]["d2h_bytes_per_request"] for b in ("batch1", "batch8")}
    fused_rm.warmup()  # the DAG on a nominal batch: wildcard dims 64, batch 1
    warm = fused_rm.infer_fn.graph_stats()
    emit("ensemble", card, entries=sorted(n for n, _ in repo.list_models()),
         data_paths={**paths_of, "ensemble_mixed": mixed.spec.extra["data_path"]},
         step_precision=fused_rm.spec.extra["step_precision"],
         requests={"batch1": len(b1), "batch8": len(b8)}, frame_hw=list(FRAME_HW),
         launches=counts, graph_replays=after["replays"] - before["replays"],
         fused_equals={"host": True, "hand_chain": True, "ensemble_crop_pipeline": True,
                       "mixed": True}, kept=kept, paths=report,
         host_minus_fused_bytes_per_request=saved,
         warmup_graph={"shape": [1, 64, 64, 3], "keys": warm["keys"],
                       "pool_bytes": warm["pool_bytes"]},
         wall_s=time.perf_counter() - t_phase)
    return k1


# phase 33: the load generator against `serve` in a process of its own
LOADGEN_CLIENTS, LOADGEN_WINDOW_S, LOADGEN_STAGGER_S = 4, 1.5, 0.1
LOADGEN_SLO_MS, LOADGEN_PROBE_S, LOADGEN_ITERS = 33.0, 2.0, 4  # a 30 fps camera
LOADGEN_MODELS = (("yolov5_crop", "images"), ("ensemble_fused_pipeline", "camera_raw"))


def start_serve(root: pathlib.Path, flags=(), timeout_s: float = 180.0):
    """``python -m triton_client_tpu_torch serve -r root [flags]`` on a
    loopback port of its choosing: (process, address, its output lines so
    far, the reader thread that drains its output)."""
    return wait_serve(spawn_serve(root, flags), timeout_s)


def spawn_serve(root: pathlib.Path, flags=(), command=("-m", "triton_client_tpu_torch")):
    """Start ``<python> <command> serve -r root [flags]`` without waiting:
    (process, its output lines, the reader thread that drains them, the
    queue its port arrives on)."""
    import queue
    import threading

    proc = subprocess.Popen(
        [sys.executable, *command, "serve", "-r", str(root), "-a", "127.0.0.1:0", "--uds",
         "off", *flags],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: list[str] = []
    ports: queue.Queue = queue.Queue()

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if "listening on port" in line:
                ports.put(int(line.split()[-1]))
        ports.put(None)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    return proc, lines, reader, ports


def wait_serve(spawned, timeout_s: float = 180.0):
    """A spawned ``serve``'s port: (process, address, lines, reader); a
    server that does not start is stopped and fails the run."""
    import queue

    proc, lines, reader, ports = spawned
    try:
        port = ports.get(timeout=timeout_s)
    except queue.Empty:
        port = None
    if port is None:
        stop_serve(proc, reader)
        fail(f"serve did not start: {lines[-20:]}")
    return proc, f"127.0.0.1:{port}", lines, reader


def stop_serve(proc, reader) -> int:
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    reader.join(timeout=30)
    return proc.returncode


def run_loadgen(card: str) -> None:
    """Phase 33: ``serve`` on the phase-32 repository in a process of its
    own, and ``utils/loadgen`` driving ``yolov5_crop`` and
    ``ensemble_fused_pipeline`` on loopback with one seeded 480x640 frame a
    request: ``run_pool`` with 4 clients for 1.5 s in each mode (unary;
    stream and async with 2 in flight), ``run_open_loop`` at half the
    unary closed loop's frames/s for 1.5 s, and ``slo_capacity_search`` at a
    33 ms SLO (a 30 fps camera) with 2 s probes and 4 bisections. Every run
    must end with no error and no unanswered request; reports frames/s,
    p50, p99, errors and capacity."""
    import tempfile

    from triton_client_tpu_torch.io.sources import SyntheticImageSource
    from triton_client_tpu_torch.utils import loadgen

    t_phase = time.perf_counter()
    frame = next(iter(SyntheticImageSource(1, FRAME_HW, seed=33))).data[None]
    results = {}
    with tempfile.TemporaryDirectory(prefix="loadgen_repo_") as tmp:
        proc, address, lines, reader = start_serve(ensemble_repository(pathlib.Path(tmp)))
        t_ready = time.perf_counter() - t_phase
        try:
            for model, key in LOADGEN_MODELS:
                scenario = [(model, {key: frame})]
                row = {}
                for mode in ("unary", "stream", "async"):
                    res = loadgen.run_pool(address, model, {key: frame}, LOADGEN_CLIENTS,
                                           LOADGEN_WINDOW_S, deadline_s=120.0,
                                           stagger_s=LOADGEN_STAGGER_S, mode=mode,
                                           inflight=1 if mode == "unary" else 2)
                    check(not res.errors and res.served_frames > 0,
                          f"{model} {mode}: {res.served_frames} frames, errors {res.errors[:3]}")
                    lat = np.asarray(res.latencies_ms)
                    row[mode] = {"frames_per_s": res.fps, "p50_ms": float(np.percentile(lat, 50)),
                                 "p99_ms": float(np.percentile(lat, 99)),
                                 "frames": res.served_frames, "errors": len(res.errors)}
                rate = row["unary"]["frames_per_s"] / 2
                res = loadgen.run_open_loop(address, scenario, rate_qps=rate,
                                            duration_s=LOADGEN_WINDOW_S, seed=33)
                check(not res.errors and res.completed == res.scheduled > 0,
                      f"{model} open loop: {res.completed} of {res.scheduled}, "
                      f"errors {res.errors[:3]}")
                row["open_loop"] = {"offered_qps": rate, "achieved_qps": res.achieved_qps,
                                    "scheduled": res.scheduled, "completed": res.completed,
                                    "p50_ms": res.percentile(50), "p99_ms": res.percentile(99),
                                    "errors": len(res.errors)}
                cap = loadgen.slo_capacity_search(
                    address, scenario, LOADGEN_SLO_MS, duration_s=LOADGEN_PROBE_S, seed=33,
                    qps_lo=rate / 2, qps_hi=8 * rate, iters=LOADGEN_ITERS)
                errors = sum(p["errors"] for p in cap["probes"])
                unanswered = sum(p["scheduled"] - p["completed"] for p in cap["probes"])
                check(errors == 0 and unanswered == 0,
                      f"{model} capacity search: {errors} errors, {unanswered} unanswered")
                row["slo_capacity"] = {**cap, "errors": errors}
                results[model] = row
        finally:
            code = stop_serve(proc, reader)
    check(code is not None, "serve did not stop")
    emit("loadgen", card, address=address, clients=LOADGEN_CLIENTS, window_s=LOADGEN_WINDOW_S,
         frame_hw=list(FRAME_HW), slo_ms=LOADGEN_SLO_MS, probe_s=LOADGEN_PROBE_S,
         serve_ready_s=t_ready, serve_exit=code, models=results,
         wall_s=time.perf_counter() - t_phase)


# phase 34: SECOND-IoU's sparse middle at the reference's 0.05 m grid
SPARSE_YAML = "data/kitti_second_sparse005.yaml"
SPARSE_ENTRY = "second_sparse005"
SPARSE_REQUESTS = 50  # captured requests a scan size for p50 and scans/s
SPARSE_TINY_SCANS = 3  # golden-config scans held card against CPU at the tests' bars
# the full-width card against CPU: labels and order equal, boxes and scores
# within SPARSE_FULL_TOL of the CPU's (both float32, TF32 off; cuDNN and the
# CPU sum the 320-channel BEV convolutions in other orders)
SPARSE_FULL_TOL = 1e-4


def sparse_levels(model, pts, cnt) -> tuple[list[dict], list[tuple]]:
    """The sparse middle's levels for one padded scan, as its encoder builds
    them (``ops/sparse_conv``): each level's live sites against its budget,
    the cells it would hold without the cap (the level-0 occupancy, then
    the unique coarse cells of the level above), whether the cap bound, and
    the level's sites (for the card-against-CPU comparison)."""
    from triton_client_tpu_torch.ops import sparse_conv as sp

    cfg = model.cfg
    budget = model.sparse_budget
    nx, ny, nz = cfg.voxel.grid_size
    with torch.no_grad():
        vs = sp.points_to_voxelset(pts, cnt, cfg.voxel, budget)
        ijk, valid = sp.assign_cells(pts, cnt, cfg.voxel)
        ids = sp.linear_ids(ijk.flip(1), valid, (nz, ny, nx))
        want = int(torch.unique(ids[ids < nz * ny * nx]).numel())
        levels = [{"level": 0, "grid": list(vs.grid), "budget": budget,
                   "live": int(vs.valid.sum()), "cells": want}]
        sets = [(vs.ijk, vs.valid)]
        for si in range(1, len(cfg.middle_filters)):
            if cfg.sparse_dense_tail_from and si >= cfg.sparse_dense_tail_from:
                break
            budget = max(budget // 2, 8192)
            free = sp.downsample_sites(vs, vs.ijk.shape[0])  # no cap: every coarse cell
            vs = sp.downsample_sites(vs, budget)
            levels.append({"level": si, "grid": list(vs.grid), "budget": budget,
                           "live": int(vs.valid.sum()), "cells": int(free.valid.sum())})
            sets.append((vs.ijk, vs.valid))
    for lv in levels:
        lv["cap_bound"] = lv["cells"] > lv["budget"]
        check(lv["live"] == min(lv["cells"], lv["budget"]),
              f"level {lv['level']}: {lv['live']} live sites for {lv['cells']} cells")
    return levels, sets


def run_second_sparse(card: str, counters) -> dict:
    """Phase 34: SECOND-IoU with the sparse middle at the reference's 0.05 m
    grid (``data/kitti_second_sparse005.yaml``: 1408 x 1600 x 40 cells,
    budgets 65,536 / 32,768 / 16,384, a dense tail from stage 3, a 320-channel
    BEV at 200 x 176, 211,200 anchors), seeded, on the synthetic KITTI scans
    of phases 12-16 (20,000 and 120,000 points). Held: the captured body
    bitwise equal to the eager one at both buckets, one launch each of
    kernels 3 and 4 and none of kernel 5 an eager scan; each level's sites
    on the card equal to the CPU's; the card's rows against the port's CPU
    run on the same weights (the golden config of the tests at their 1e-5
    bars, and full width at SPARSE_FULL_TOL); through CUDAChannel one launch
    of kernels 3 and 4 a request and no other, no capture in the counted
    window, rows equal to the in-process pipeline's bit for bit; and
    ``detect3d --config`` in-process equal to ``detect3d -u grpc:`` against
    ``serve`` over a disk entry whose ``dataset:`` is the YAML. Prints each
    level's live sites against its budget, p50 and scans/s over
    SPARSE_REQUESTS captured requests a size, device ms, busy share and the
    top device ops a request, the middle's own device ms and the graph
    pool's bytes. Returns the main path's launches of kernels 3 and 4."""
    import shutil
    import tempfile

    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.cli import detect3d as detect3d_cli
    from triton_client_tpu_torch.cli import serve as serve_cli
    from triton_client_tpu_torch.dataset_config import detect3d_from_yaml
    from triton_client_tpu_torch.drivers.driver import channel_infer3d
    from triton_client_tpu_torch.io.sources import SyntheticPointCloudSource
    from triton_client_tpu_torch.models.second import SECONDConfig
    from triton_client_tpu_torch.ops import sparse_conv as sp
    from triton_client_tpu_torch.ops.voxelize import VoxelConfig
    from triton_client_tpu_torch.pipelines.detect3d import (
        Detect3DConfig,
        build_second_pipeline,
        prepare_points,
    )
    from triton_client_tpu_torch.runtime.repository import ModelRepository

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    _, model_cfg, cfg = detect3d_from_yaml(str(ROOT / SPARSE_YAML))
    t0 = time.perf_counter()
    pipe, spec, model = build_second_pipeline(model_cfg=model_cfg, config=cfg, device="cuda",
                                              seed=0)
    cpu_pipe, _, _ = build_second_pipeline(model_cfg=model_cfg, config=cfg, device="cpu",
                                           seed=0)
    build_s = time.perf_counter() - t0
    mc = model.cfg
    check(mc.middle == "sparse" and mc.voxel.grid_size == (1408, 1600, 40)
          and model.sparse_budget == 65536 and mc.sparse_dense_tail_from == 3
          and mc.sparse_stride_kernel == 2 and mc.middle_filters == (16, 32, 64, 64)
          and mc.head_hw == (200, 176) and mc.bev_channels == 320
          and model.anchors.shape[0] == 211200 and cfg.pre_max == 256
          and cfg.point_buckets[-1] == 131072, "not the reference's 0.05 m SECOND")
    check(pipe.fused_stages == ("decode_nms",) and pipe.use_scatter,
          f"the sparse SECOND's fused stages are {pipe.fused_stages}")
    scans = {n: [f.data for f in SyntheticPointCloudSource(3, points=n, seed=20 + i)]
             for i, n in enumerate(SCAN_POINTS)}

    def on_card(pc):
        padded, m = prepare_points(pc, 4, cfg.point_buckets)
        return (torch.from_numpy(padded).to(dev), torch.tensor(m, dtype=torch.int32).to(dev))

    # -- the levels, on the card against the CPU ------------------------------------------
    levels = {}
    for n, pcs in scans.items():
        pts, cnt = on_card(pcs[0])
        card_levels, card_sets = sparse_levels(model, pts, cnt)
        cpu_levels, cpu_sets = sparse_levels(cpu_pipe.model, pts.cpu(), cnt.cpu())
        check(card_levels == cpu_levels, f"{n} points: the card's levels {card_levels} differ "
              f"from the CPU's {cpu_levels}")
        for (ijk, valid), (cijk, cvalid) in zip(card_sets, cpu_sets):
            check(torch.equal(ijk.cpu(), cijk) and torch.equal(valid.cpu(), cvalid),
                  f"{n} points: a level's sites on the card differ from the CPU's")
        levels[n] = card_levels
    check(not levels[SCAN_POINTS[0]][0]["cap_bound"], "the 20k scan overflowed level 0")
    check(levels[SCAN_POINTS[1]][0]["cap_bound"], "the 120k scan did not fill level 0")

    # -- captured against eager at both buckets ------------------------------------------
    capture = {}
    for n, pcs in scans.items():
        a, b = on_card(pcs[0]), on_card(pcs[1])
        per_call, _, _ = hold_captured_to_eager(pipe, a, b, counters, f"sparse SECOND {n}")
        capture[n] = {c_name: k for c_name, k in zip(COUNTER_NAMES, per_call) if k}
        check(capture[n] == {"residual_decode_3d": 1, "suppress_pack_3d": 1,
                             "residual_decode_3d_gathered": 1},
              f"one eager sparse SECOND scan at {n} points launched {capture[n]}")
    emit("second_sparse_levels", card, yaml=SPARSE_YAML, grid=list(mc.voxel.grid_size),
         budget=model.sparse_budget, levels={str(n): lv for n, lv in levels.items()},
         card_equals_cpu=True, captured_equals_eager=True, eager_launches_per_scan=capture,
         replays=GRAPH_REPLAYS, build_s=build_s)

    # -- the card against the CPU: the tests' golden config, then full width --------------
    tiny_cfg = SECONDConfig(
        voxel=VoxelConfig(point_cloud_range=(0.0, -12.8, -2.0, 25.6, 12.8, 2.0),
                          voxel_size=(0.4, 0.4, 0.5), max_voxels=2048, max_points_per_voxel=8),
        middle="sparse", sparse_budget=2048, sparse_dense_tail_from=2, middle_filters=(8, 8, 8),
        backbone_layers=(1,), backbone_strides=(1,), backbone_filters=(16,),
        upsample_strides=(1,), upsample_filters=(16,))
    tiny_pipe = Detect3DConfig(model_name="second_iou", point_buckets=(8192,), max_det=16,
                               pre_max=64)
    tiny = {d: build_second_pipeline(model_cfg=tiny_cfg, config=tiny_pipe, device=d, seed=0)[0]
            for d in ("cuda", "cpu")}
    tiny_err, tiny_kept = card_vs_cpu(
        tiny["cuda"], tiny["cpu"],
        uniform_clouds(34, (0.0, -12.8, -1.8, 25.6, 12.8, 1.8), 3000, SPARSE_TINY_SCANS))
    full = {}
    for n, pcs in scans.items():
        g, c = pipe.infer(pcs[0]), cpu_pipe.infer(pcs[0])
        k = len(g["pred_scores"])
        check(k == len(c["pred_scores"]) > 0, f"{n} points: the card keeps {k} rows, the CPU "
              f"{len(c['pred_scores'])}")
        check(np.array_equal(g["pred_labels"], c["pred_labels"]),
              f"{n} points: the card's labels or order differ from the CPU's")
        err = max(float(np.abs(g[key] - c[key]).max()) for key in ("pred_boxes", "pred_scores"))
        check(err <= SPARSE_FULL_TOL, f"{n} points: card and CPU rows differ by {err}")
        with torch.no_grad():
            hg = pipe.heads(*on_card(pcs[0]))
            hc = cpu_pipe.heads(*(t.cpu() for t in on_card(pcs[0])))
        head_err = {key: float((hg[key].cpu() - hc[key]).abs().max()) for key in hc}
        head_max = {key: float(hc[key].abs().max()) for key in hc}
        full[str(n)] = {"rows": k, "max_abs_err": err, "heads_max_abs_err": head_err,
                        "heads_max_abs": head_max}
    emit("second_sparse_check", card, tiny={"config": "tests/test_torch_second_sparse.GOLDEN",
                                            "scans": SPARSE_TINY_SCANS, "rows": tiny_kept,
                                            "max_abs_err": tiny_err, "bar": 1e-5},
         full_width=full, full_width_bar=SPARSE_FULL_TOL, labels_and_order_equal=True)

    # -- the main path: scans through CUDAChannel, counted ---------------------------------
    repo = ModelRepository()
    repo.register(spec, pipe.infer_fn(), warmup=pipe.warmup)
    repo.get(spec.name).warmup()  # a graph a point bucket
    channel = CUDAChannel(repo)
    channel.register_channel()
    infer = channel_infer3d(channel, spec.name)
    for pcs in scans.values():  # warm-up, not counted
        infer(pcs[0])
    torch.cuda.synchronize()
    captures = repo.get(spec.name).infer_fn.graph_stats()["captures"]
    requests = [pc for pcs in scans.values() for pc in pcs]
    for counter in counters:
        counter.reset()
    outs = [infer(pc) for pc in requests]
    torch.cuda.synchronize()
    launches = dict(zip(COUNTER_NAMES, (c.count for c in counters)))
    want_launches = {name: 0 for name in COUNTER_NAMES}
    for name in ("residual_decode_3d", "suppress_pack_3d", "residual_decode_3d_gathered"):
        want_launches[name] = len(requests)
    check(launches == want_launches, f"sparse SECOND launches {launches}, want {want_launches}")
    check(repo.get(spec.name).infer_fn.graph_stats()["captures"] == captures,
          "a request captured a graph inside the counted window")
    for pc, o in zip(requests, outs):
        k = len(o["pred_scores"])
        check(0 < k <= cfg.max_det and o["pred_boxes"].shape == (k, 7), "misshapen rows")
        check(all(bool(np.isfinite(v).all()) for v in o.values()), "non-finite rows")
        check(1 <= o["pred_labels"].min() and o["pred_labels"].max() <= 3, "labels")
        want = pipe.infer(pc)
        check(all(o[key].tobytes() == want[key].tobytes() for key in want),
              "the served rows differ from the in-process pipeline's")
    graphs = repo.get(spec.name).infer_fn.graph_stats()
    emit("second_sparse_main_path", card, model=SPARSE_ENTRY, points=list(SCAN_POINTS),
         requests=len(requests), kept=[len(o["pred_scores"]) for o in outs],
         launches=launches, no_capture_in_window=True, bitwise_equal_in_process=True,
         graphs=graphs, param_bytes=spec.extra["param_bytes"])

    # -- times on the card's clock --------------------------------------------------------
    e2e = {f"points{n}": serve(infer, pcs, SPARSE_REQUESTS) for n, pcs in scans.items()}
    profiles = {f"points{n}": device_profile(lambda pc=pcs[0]: infer(pc), PROFILE_REQUESTS)
                for n, pcs in scans.items()}
    middle = {}
    with torch.no_grad():
        for n, pcs in scans.items():
            pts, cnt = on_card(pcs[0])
            vs = sp.points_to_voxelset(pts, cnt, mc.voxel, model.sparse_budget)
            middle[f"points{n}"] = {
                "vfe": device_profile(lambda: sp.points_to_voxelset(
                    pts, cnt, mc.voxel, model.sparse_budget), PROFILE_REQUESTS),
                "middle": device_profile(lambda: model.middle(vs.ijk, vs.feats, vs.valid),
                                         PROFILE_REQUESTS)}
    emit("second_sparse_times", card, in_process=e2e, profile=profiles, middle_eager=middle,
         graph_pool_bytes=graphs["pool_bytes"], graph_captures=graphs["captures"])

    # -- detect3d --config in-process and -u grpc: against serve ----------------------------
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="second_sparse_"))
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        clouds = tmp / "clouds"
        clouds.mkdir()
        for i, pc in enumerate((scans[SCAN_POINTS[0]][0], scans[SCAN_POINTS[1]][0],
                                scans[SCAN_POINTS[1]][1])):
            np.save(clouds / f"{i:03d}.npy", pc)
        root = tmp / "repo"
        (root / SPARSE_ENTRY).mkdir(parents=True)
        (root / SPARSE_ENTRY / "config.yaml").write_text(
            f"family: second_iou\ndataset: {ROOT / SPARSE_YAML}\n")
        for counter in counters:
            counter.reset()
        report = cli_in_process(detect3d_cli.main, [
            "--config", SPARSE_YAML, "-i", str(clouds), "--sink", "jsonl", "-o",
            str(tmp / "config_run")])
        local, _ = replay_rows(tmp / "config_run")
        cli_launches = dict(zip(COUNTER_NAMES, (c.count for c in counters)))
        args = serve_cli.parser().parse_args(["-r", str(root), "-a", "127.0.0.1:0", "--uds",
                                              "off", "--warmup", "--max-workers", "4"])
        server = serve_cli.build_server(args)
        server.start()
        try:
            for counter in counters:
                counter.reset()
            remote_report, remote = client_run(
                "detect3d", ["-m", SPARSE_ENTRY, "-i", str(clouds), "-u",
                             f"grpc:127.0.0.1:{server.port}", "--no-shm"], tmp / "remote", True)
            torch.cuda.synchronize()
            remote_launches = dict(zip(COUNTER_NAMES, (c.count for c in counters)))
        finally:
            server.stop()
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp)
    check(len(local) == 3 and all(len(r["pred_scores"]) > 0 for r in local),
          f"detect3d --config kept {[len(r['pred_scores']) for r in local]}")
    check(remote == local, "detect3d -u grpc: rows differ from detect3d --config in-process")
    check(remote_report["transport"] == "grpc", f"transport {remote_report['transport']}")
    remote_requests = remote_report["driver"]["ticks"] + 1  # and the driver's warmup call
    check(remote_launches["suppress_pack_3d"] == remote_launches["residual_decode_3d"]
          == remote_requests and remote_launches["segment_mean"] == 0,
          f"remote launches {remote_launches} for {remote_requests} requests")
    emit("second_sparse_cli", card, config_run={"scans": report["scans"],
                                                "detections": report["detections"],
                                                "scans_per_s": report["driver"]["fps"],
                                                "launches": cli_launches},
         remote={"scans_per_s": remote_report["driver"]["fps"],
                 "p50_ms": remote_report["driver"]["p50_ms"], "launches": remote_launches,
                 "requests": remote_requests, "transport": remote_report["transport"]},
         remote_equals_config_run=True, wall_s=time.perf_counter() - t_phase)
    return {"residual_decode_3d": launches["residual_decode_3d"],
            "suppress_pack_3d": launches["suppress_pack_3d"]}


# phase 35: the three served entries of the façade (examples/), requests
# each with and without a ledger and in the profiler window, the slack of
# the CUPTI kernel time over the ledger's windows, the share of device time
# no model may own, the frames of the profiled detect2d run
TELEMETRY_ENTRIES = ("yolov5_crop", "pointpillar_kitti", "second_iou")
TELEMETRY_REQUESTS, TELEMETRY_SLACK, TELEMETRY_UNATTRIBUTED = 20, 0.02, 0.05
TELEMETRY_CLI_FRAMES = 8
# the kernels each entry's path launches once a request (COUNTER_NAMES),
# and the CUDA functions each kernel runs (obs/opstats.KERNEL_STAGES)
TELEMETRY_PATHS = {"yolov5_crop": ("decode_nms_2d",),
                   "pointpillar_kitti": ("residual_decode_3d", "suppress_pack_3d"),
                   "second_iou": ("residual_decode_3d", "suppress_pack_3d", "segment_mean")}
KERNEL_FUNCTIONS = {
    "decode_nms_2d": ("decode_nms_2d_order", "decode_nms_2d_mask", "decode_nms_2d_scan"),
    "residual_decode_3d": ("residual_decode_3d_kernel",),
    "suppress_pack_3d": ("suppress_pack_3d_order", "suppress_pack_3d_mask",
                         "suppress_pack_3d_scan"),
    "segment_mean": ("segment_mean_zero", "segment_mean_walk"),
}


def telemetry_repository(tmp: pathlib.Path) -> pathlib.Path:
    """The phase-35 repository root: copies of the three entries'
    ``config.yaml``, ``yolov5_crop`` with a seeded ultralytics checkpoint in
    a version dir (``detect2d -r`` reads trained artifacts only), the 3D
    entries seeded at build."""
    for name in TELEMETRY_ENTRIES:
        (tmp / name).mkdir(parents=True)
        (tmp / name / "config.yaml").write_bytes(
            (ROOT / "examples" / name / "config.yaml").read_bytes())
    (tmp / "yolov5_crop" / "1").mkdir()
    torch.save({"model": upstream_yolov5("n", 35)}, tmp / "yolov5_crop" / "1" / "weights.pt")
    return tmp


def network_flops(name: str, pipe, inputs: dict) -> int:
    """FlopCounterMode's flops of one request's network: YOLOv5's forward on
    the frames at its input size (``forward_gflops`` x batch), or a 3D
    pipeline's voxel stage and model (``heads``)."""
    from torch.utils.flop_counter import FlopCounterMode

    if name == "yolov5_crop":
        model = _model_of(pipe)
        x = torch.zeros((inputs["images"].shape[0], *pipe.config.input_hw, 3),
                        dtype=next(model.parameters()).dtype, device="cuda")
        return round(forward_gflops(model, x) * 1e9 * x.shape[0])
    points = torch.from_numpy(inputs["points"]).cuda()
    count = torch.from_numpy(inputs["num_points"]).cuda()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        pipe.heads(points, count)
    return counter.get_total_flops()


def window_ledger():
    """A ``DeviceTimeLedger`` that also keeps each window it records (its
    ``windows``)."""
    from triton_client_tpu_torch.obs.device_time import DeviceTimeLedger

    class Ledger(DeviceTimeLedger):
        def __init__(self) -> None:
            super().__init__()
            self.windows: list[float] = []

        def record(self, model, duration_s, spec_extra=None, tenant=None) -> None:
            self.windows.append(duration_s)
            super().record(model, duration_s, spec_extra, tenant)

    return Ledger()


def profiled_requests(channel, name: str, requests: list, counters, tmp: pathlib.Path,
                      sessions: int = 3) -> tuple:
    """``requests`` through ``channel`` under torch.profiler with a fresh
    ledger attached, the trace exported and summarized by ``obs/opstats``:
    (summary, ledger, launches by kernel). torch.profiler has dropped
    records of µs-long kernels on the card before (pass_split), so up to
    ``sessions`` windows are taken until one saw every launch of the path's
    kernels."""
    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.obs import opstats

    for session in range(1, sessions + 1):
        ledger = window_ledger()
        channel.attach_device_time(ledger)
        torch.cuda.synchronize()
        for counter in counters:
            counter.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for inputs in requests:
                channel.do_inference(InferRequest(name, inputs))
            torch.cuda.synchronize()
        launches = dict(zip(COUNTER_NAMES, (c.count for c in counters)))
        path = tmp / f"{name}.{session}.trace.json"
        prof.export_chrome_trace(str(path))
        summary = opstats.summarize(opstats.load_trace(str(path)))
        seen = kernel_rows(summary, name)
        if all(seen.get(fn, 0) == launches[k] for k in TELEMETRY_PATHS[name]
               for fn in KERNEL_FUNCTIONS[k]):
            summary["sessions"] = session
            return summary, ledger, launches
    fail(f"{name}: in {sessions} profiler sessions the last saw kernel rows {seen} "
         f"for launches {launches}")


def kernel_rows(summary: dict, model: str) -> dict:
    """{CUDA function: occurrences} of the hand kernels' rows under ``model``."""
    from triton_client_tpu_torch.obs import opstats

    out: dict[str, int] = {}
    for row in summary["ops"]:
        fn = opstats.kernel_function(row["op"])
        if fn in opstats.KERNEL_STAGES and row["model"] == model:
            out[fn] = out.get(fn, 0) + row["occurrences"]
    return out


def run_telemetry(card: str, counters) -> None:
    """Phase 35: the measurement units on the card. ``scan_disk`` builds
    copies of examples/yolov5_crop (a seeded checkpoint), pointpillar_kitti
    and second_iou at full width, served by CUDAChannel; each entry takes
    TELEMETRY_REQUESTS serial requests (YOLOv5 a uint8 camera frame at its
    512² input, the 3D
    entries 20,000- and 120,000-point scans in turn) with no ledger, then
    with a ``DeviceTimeLedger`` attached (its first launch measures the
    model's flops and bytes, outside the counted windows), then again under
    torch.profiler with a fresh ledger. Held: the ledger counts one launch a
    request; each request's CUDA-event window is at most its host wall;
    ``flops_per_call`` equals FlopCounterMode's count of the network
    (``forward_gflops`` x batch for YOLOv5); the kernel time obs/opstats
    attributes to the model over the profiler window is at most the
    ledger's device time + TELEMETRY_SLACK; every CUDA function of the
    path's kernels (1; 3 and 4; 3, 4 and 5) has a row under the model with
    occurrences equal to the kernel's launches; the unattributed share of
    device time is below TELEMETRY_UNATTRIBUTED. Then ``detect2d -r
    --profile-trace`` and ``trace-dump --ops`` as processes of their own
    (kernel 1's rows under yolov5_crop) and the ``roofline`` tool on a model
    snapshot of the three. Lines telemetry (per model: busy share, MFU over
    the wall and over the busy time, p50 with and without the ledger, the
    measured cost and its roofline row, the op attribution) and
    telemetry_cli."""
    import contextlib
    import io
    import shutil
    import tempfile

    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.cli import tools
    from triton_client_tpu_torch.obs import opstats
    from triton_client_tpu_torch.obs import roofline as roof
    from triton_client_tpu_torch.pipelines.detect3d import prepare_points
    from triton_client_tpu_torch.runtime.disk_repository import scan_disk

    t_phase = time.perf_counter()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="telemetry_"))
    cwd = os.getcwd()
    os.chdir(ROOT)  # the entries name data/ files relative to the checkout
    try:
        root = telemetry_repository(tmp / "repo")
        t0 = time.perf_counter()
        repo = scan_disk(root)
        for name, _ in repo.list_models():
            repo.get(name).warmup()
        build_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    check(sorted(repo.names()) == sorted(TELEMETRY_ENTRIES), f"scanned {repo.names()}")
    channel = CUDAChannel(repo)
    rng = np.random.default_rng(35)
    hw = tuple(repo.metadata("yolov5_crop").extra["model_input_hw"])
    requests = {"yolov5_crop": [{"images": rng.integers(0, 256, (1, *hw, 3), dtype=np.uint8)}
                                for _ in range(TELEMETRY_REQUESTS)]}
    for name in TELEMETRY_ENTRIES[1:]:
        extra = repo.metadata(name).extra
        clouds = [uniform_clouds(350 + i, (0.0, -39.68, -3.0, 69.12, 39.68, 1.0), n, 1)[0]
                  for i, n in enumerate(SCAN_POINTS)]
        scans = []
        for pc in clouds:
            padded, m = prepare_points(pc, 4, extra["point_buckets"], extra["z_offset"])
            scans.append({"points": padded, "num_points": np.asarray(m, np.int32)})
        requests[name] = [scans[i % len(scans)] for i in range(TELEMETRY_REQUESTS)]

    def timed(name: str) -> list[float]:
        walls = []
        for inputs in requests[name]:
            t = time.perf_counter()
            out = channel.do_inference(InferRequest(name, inputs)).outputs
            walls.append(time.perf_counter() - t)
            check(bool(np.isfinite(out["detections"]).all()), f"{name}: non-finite detections")
        return walls

    rows, snapshot_models = {}, []
    for name in TELEMETRY_ENTRIES:
        spec = repo.metadata(name)
        pipe = pipeline_of(repo.get(name))
        channel.attach_device_time(None)
        channel.do_inference(InferRequest(name, requests[name][0]))  # any capture: here
        off = timed(name)
        # the first launch with a ledger measures the cost (an eager run)
        channel.attach_device_time(window_ledger())
        channel.do_inference(InferRequest(name, requests[name][0]))
        torch.cuda.synchronize()
        flops = network_flops(name, pipe, requests[name][0])
        check(spec.extra.get("flops_per_call") == spec.extra.get("measured_flops_per_call")
              == flops > 0, f"{name}: flops_per_call {spec.extra.get('flops_per_call')}, "
              f"the network's {flops}")
        check(spec.extra["launch_annotation"] == f"launch:{name}:1", f"{name}: annotation")

        ledger = window_ledger()
        channel.attach_device_time(ledger)
        for counter in counters:
            counter.reset()
        t0 = time.perf_counter()
        on = timed(name)
        wall_s = time.perf_counter() - t0
        snap = ledger.snapshot()
        launches = dict(zip(COUNTER_NAMES, (c.count for c in counters)))
        check(snap["launches"] == {name: TELEMETRY_REQUESTS},
              f"{name}: the ledger counted {snap['launches']}")
        check(len(ledger.windows) == len(on) and all(0 < w <= h for w, h in
                                                     zip(ledger.windows, on)),
              f"{name}: a CUDA-event window past its request's wall: "
              f"{list(zip(ledger.windows, on))}")
        want = {k: TELEMETRY_REQUESTS if k in TELEMETRY_PATHS[name] else 0
                for k in COUNTER_NAMES if k != "residual_decode_3d_gathered"}
        check({k: launches[k] for k in want} == want, f"{name}: launches {launches}")
        device_s = sum(ledger.windows)
        precision = spec.extra.get("compute_precision") or spec.extra.get("precision")
        peak = roof.peak_flops(precision)
        mfu_busy = flops * TELEMETRY_REQUESTS / device_s / peak

        summary, pledger, plaunches = profiled_requests(channel, name, requests[name],
                                                        counters, tmp)
        model_us = summary["models"].get(name, 0.0)
        ledger_us = sum(pledger.windows) * 1e6
        total_us = summary["total_op_time_us"]
        check(model_us > 0 and model_us <= ledger_us * (1 + TELEMETRY_SLACK),
              f"{name}: opstats attributes {model_us:.1f} µs of kernels, the ledger's "
              f"windows sum to {ledger_us:.1f} µs")
        unattributed = summary["unattributed_us"] / max(total_us, 1e-9)
        check(unattributed < TELEMETRY_UNATTRIBUTED,
              f"{name}: {unattributed:.2%} of device time unattributed")
        check(set(summary["models"]) == {name}, f"{name}: models {summary['models']}")
        seen = kernel_rows(summary, name)
        stages = {fn: next(r["stage"] for r in summary["ops"]
                           if opstats.kernel_function(r["op"]) == fn) for fn in seen}
        roofline_row = roof.model_row(spec.extra, TELEMETRY_REQUESTS / wall_s)
        snapshot_models.append({"model": name, "version": spec.version,
                                "roofline": roofline_row})
        rows[name] = {
            "precision": spec.extra.get("precision", "f32"),
            "compute_precision": precision,
            "requests": TELEMETRY_REQUESTS,
            "busy_share": snap["busy_fraction"],
            "mfu": snap["window"]["mfu"].get(name),
            "mfu_busy": mfu_busy,
            "peak_flops": peak,
            "device_ms_per_request": device_s / TELEMETRY_REQUESTS * 1e3,
            "p50_ms_ledger": float(np.median(on)) * 1e3,
            "p50_ms_no_ledger": float(np.median(off)) * 1e3,
            "gflops_per_request": flops / 1e9,
            "measured_bytes_per_call": spec.extra["measured_bytes_per_call"],
            "roofline": roofline_row,
            "opstats": {"model_us": model_us, "ledger_us": ledger_us,
                        "kernel_over_ledger": model_us / ledger_us,
                        "unattributed_share": unattributed, "total_op_us": total_us,
                        "op_count": summary["op_count"], "sessions": summary["sessions"],
                        "kernel_rows": seen, "kernel_stages": stages,
                        "launches": {k: v for k, v in plaunches.items() if v},
                        "top_ops_us": [(r["op"][:60], r["time_us"]) for r in
                                       summary["ops"][:5]]},
        }
        emit("telemetry", card, model=name, **rows[name])
    channel.attach_device_time(None)

    # -- the tools as a user runs them -------------------------------------------------
    prof_dir, out = tmp / "prof", tmp / "cli"
    proc = subprocess.run(
        [sys.executable, "-m", "triton_client_tpu_torch", "detect2d", "-r", str(root),
         "-m", "yolov5_crop", "-i", f"synthetic:{TELEMETRY_CLI_FRAMES}:512x512",
         "--profile-trace", str(prof_dir), "--sink", "jsonl", "-o", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"detect2d --profile-trace exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    ops_json = tmp / "ops.json"
    dump = subprocess.run(
        [sys.executable, "-m", "triton_client_tpu_torch", "trace-dump", "--ops", str(prof_dir),
         "--top-k", "0", "-o", str(ops_json)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(dump.returncode == 0, f"trace-dump --ops exited {dump.returncode}: "
          f"{dump.stderr[-3000:]}")
    cli_summary = json.loads(ops_json.read_text())
    cli_rows = kernel_rows(cli_summary, "yolov5_crop")
    cli_launches = report["kernel_launches"]["decode_nms_2d"]
    check(set(cli_rows) == set(KERNEL_FUNCTIONS["decode_nms_2d"])
          and all(v == cli_launches for v in cli_rows.values()),
          f"trace-dump --ops: kernel 1's rows under yolov5_crop {cli_rows}, "
          f"{cli_launches} launches")
    snapshot = tmp / "models.json"
    snapshot.write_text(json.dumps({"models": snapshot_models}))
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        tools.roofline([str(snapshot), "--json"])
    roof_rows = json.loads(text.getvalue())["rows"]
    check([r["model"] for r in roof_rows] == [f"{n}:1" for n in TELEMETRY_ENTRIES],
          f"roofline rows {roof_rows}")
    emit("telemetry_cli", card, detect2d={"frames": report["frames"],
                                          "kernel_launches": cli_launches},
         trace_dump={"models_us": cli_summary["models"],
                     "unattributed_us": cli_summary["unattributed_us"],
                     "kernel_rows": cli_rows,
                     "trace_file": pathlib.Path(cli_summary["trace_file"]).name},
         roofline=roof_rows, build_s=build_s, wall_s=time.perf_counter() - t_phase)
    shutil.rmtree(tmp)


# phase 36: the telemetry and SLO planes served: `serve` in a process of its
# own without and with them, 4 closed-loop clients an entry, the endpoint
# read while it serves
PLANE_ENTRIES = ("yolov5_crop", "pointpillar_kitti")
PLANE_CLIENTS, PLANE_WINDOW_S, PLANE_SLO_MS = 4, 1.5, 33.0
PLANE_FLAGS = ("--metrics-port", "auto", "--slo-ms", "33", "--op-sample-interval", "2",
               "--history-interval", "1")
PLANE_PROFILE_TRIES = 3
# /profile refusals (409: the sampler's window held the capture guard) a
# capture may meet before it counts as a try
PLANE_PROFILE_REFUSALS = 8
# the hand kernels each entry's path runs once a request
PLANE_KERNELS = {"yolov5_crop": ("decode_nms_2d",),
                 "pointpillar_kitti": ("residual_decode_3d", "suppress_pack_3d")}


def plane_repository(tmp: pathlib.Path) -> pathlib.Path:
    """Copies of examples/yolov5_crop (at conf 0.05: seeded weights keep
    nothing at 0.3) and pointpillar_kitti."""
    for name in PLANE_ENTRIES:
        (tmp / name).mkdir()
        (tmp / name / "config.yaml").write_bytes(
            (ROOT / "examples" / name / "config.yaml").read_bytes())
    crop = tmp / "yolov5_crop" / "config.yaml"
    check("conf_thresh: 0.3" in crop.read_text(), "examples/yolov5_crop changed its conf_thresh")
    crop.write_text(crop.read_text().replace("conf_thresh: 0.3", "conf_thresh: 0.05"))
    return tmp


def plane_workload(address: str) -> list[tuple]:
    """(label, model, inputs) of the phase: a seeded 480x640 frame, and
    20,000- and 120,000-point scans padded to the served entry's buckets."""
    from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel
    from triton_client_tpu_torch.io.sources import SyntheticImageSource
    from triton_client_tpu_torch.pipelines.detect3d import prepare_points

    chan = GRPCChannel(address)
    try:
        extra = chan.get_metadata("pointpillar_kitti").extra
    finally:
        chan.close()
    out = [("yolov5_crop", "yolov5_crop",
            {"images": next(iter(SyntheticImageSource(1, FRAME_HW, seed=36))).data[None]})]
    for i, n in enumerate(SCAN_POINTS):
        pc = uniform_clouds(360 + i, (0.0, -39.68, -3.0, 69.12, 39.68, 1.0), n, 1)[0]
        padded, m = prepare_points(pc, 4, extra["point_buckets"], extra["z_offset"])
        out.append((f"pointpillar_kitti_{n}", "pointpillar_kitti",
                    {"points": padded, "num_points": np.asarray(m, np.int32)}))
    return out


def plane_pool(address: str, workload: list[tuple], lines: list) -> dict:
    """``run_pool`` with PLANE_CLIENTS clients for PLANE_WINDOW_S an entry:
    frames/s, p50, p99, the frames answered in the window and the pool's
    wall (its warm requests included)."""
    from triton_client_tpu_torch.utils import loadgen

    rows = {}
    for label, model, inputs in workload:
        t0 = time.perf_counter()
        res = loadgen.run_pool(address, model, inputs, PLANE_CLIENTS, PLANE_WINDOW_S,
                               deadline_s=120.0, stagger_s=0.1)
        wall = time.perf_counter() - t0
        check(not res.errors and res.served_frames > 0,
              f"{label}: {res.served_frames} frames in {wall:.1f} s, errors "
              f"{[e[:160] for e in res.errors[:3]]}; serve said {lines[-8:]}")
        lat = np.asarray(res.latencies_ms)
        rows[label] = {"frames_per_s": res.fps, "p50_ms": float(np.percentile(lat, 50)),
                       "p99_ms": float(np.percentile(lat, 99)), "frames": res.served_frames,
                       "pool_wall_s": wall}
    return rows


def http_json(url: str, timeout: float = 60.0):
    """(status, parsed JSON body or None) of a GET."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, None


def plane_profile(base: str, address: str, workload: list[tuple]) -> dict:
    """``/profile?seconds=1`` while one client an entry drives yolov5_crop
    and the 20k scans: up to PLANE_PROFILE_TRIES captures (a window that
    dropped a kernel's records takes another; a 409 from the sampler's
    window is asked again, up to PLANE_PROFILE_REFUSALS times, and is no
    try) until kernel 1's functions sit under yolov5_crop and kernels 3
    and 4's under pointpillar_kitti. Returns the kernel rows by model, the
    tries, the refusals met and the capture's wall (the window, the
    session's stop and the parse)."""
    import threading

    from triton_client_tpu_torch.obs import opstats
    from triton_client_tpu_torch.utils import loadgen

    want = {model: {fn for k in kernels for fn in KERNEL_FUNCTIONS[k]}
            for model, kernels in PLANE_KERNELS.items()}
    rows: dict = {}
    attempt = refused = 0
    while attempt < PLANE_PROFILE_TRIES:
        errors: list = []

        def drive(model, inputs):
            res = loadgen.run_pool(address, model, inputs, 1, 2.0, deadline_s=120.0,
                                   stagger_s=0.0)
            errors.extend(res.errors)

        threads = [threading.Thread(target=drive, args=(model, inputs))
                   for _, model, inputs in workload[:2]]
        for t in threads:
            t.start()
        time.sleep(0.5)
        t0 = time.perf_counter()
        code, doc = http_json(base + "/profile?seconds=1&top_k=0", timeout=300.0)
        wall = time.perf_counter() - t0
        for t in threads:
            t.join(timeout=120)
        check(not errors and not any(t.is_alive() for t in threads),
              f"load under /profile: errors {errors[:3]}")
        if code == 409:
            refused += 1
            check(refused <= PLANE_PROFILE_REFUSALS,
                  f"/profile refused {refused} times (409): the sampler held the guard")
            continue
        attempt += 1
        check(code == 200 and doc and "op_summary" in doc,
              f"/profile answered {code}: {doc and doc.get('op_summary_error')}")
        rows = {model: kernel_rows(doc["op_summary"], model) for model in PLANE_KERNELS}
        if all(want[m] <= set(rows[m]) for m in want):
            return {"kernel_rows": rows, "tries": attempt, "refused": refused,
                    "capture_wall_s": wall,
                    "launch_log_windows": doc["op_summary"].get("launch_log_windows"),
                    "models_us": doc["op_summary"]["models"],
                    "unattributed_us": doc["op_summary"]["unattributed_us"],
                    "stages_us": doc["op_summary"]["stages"]}
    fail(f"/profile: in {PLANE_PROFILE_TRIES} captures the last saw kernel rows {rows}; "
         f"models_us {doc['op_summary']['models']}, unattributed_us "
         f"{doc['op_summary']['unattributed_us']}, launch-log windows "
         f"{doc['op_summary'].get('launch_log_windows')}")


def run_telemetry_plane(card: str) -> None:
    """Phase 36: ``serve`` on copies of examples/yolov5_crop and
    pointpillar_kitti in a process of its own, once without telemetry and
    once with ``--metrics-port auto --slo-ms 33 --op-sample-interval 2
    --history-interval 1``; in each, ``utils/loadgen.run_pool`` with 4
    clients for 1.5 s an entry (a seeded 480x640 frame; 20,000- and
    120,000-point scans). With telemetry, held: every METRIC_TYPES family on
    /metrics; each model's e2e latency histogram count equal to the
    requests it answered (the ledger's launches, one a request); SLO met +
    missed equal to the requests answered; /snapshot's busy share in
    (0, 1]; a /profile?seconds=1 capture under load with kernel 1's
    functions under yolov5_crop and kernels 3 and 4's under
    pointpillar_kitti (obs/opstats.KERNEL_STAGES); /history with an entry of
    each model; no thread of the server alive once it stops. Line
    telemetry_plane: frames/s, p50 and p99 an entry with and without
    telemetry, attainment at 33 ms, the sampler's duty cycle, captures and
    whether its windows (not the process's first profiler session) saw the
    hand kernels."""
    import tempfile

    from triton_client_tpu_torch.obs import opstats
    from triton_client_tpu_torch.obs.collector import METRIC_TYPES

    t_phase = time.perf_counter()
    runs: dict = {}
    with tempfile.TemporaryDirectory(prefix="plane_repo_") as tmp:
        root = plane_repository(pathlib.Path(tmp))
        for mode, flags in (("off", ()), ("on", PLANE_FLAGS)):
            t0 = time.perf_counter()
            proc, address, lines, reader = start_serve(root, flags)
            ready_s = time.perf_counter() - t0
            report = {"serve_ready_s": ready_s}
            try:
                workload = plane_workload(address)
                print(f"telemetry_plane: serve ({mode}) ready in {ready_s:.1f} s", flush=True)
                report["load"] = plane_pool(address, workload, lines)
                if mode == "on":
                    report.update(plane_checks(lines, address, workload, METRIC_TYPES, opstats))
            finally:
                code = stop_serve(proc, reader)
            stopped = [line for line in lines if line.startswith("serve stopped")]
            check(code is not None and stopped, f"serve ({mode}) did not stop: {lines[-5:]}")
            report["threads_after_stop"] = stopped[-1].split(":", 1)[1].strip()
            check(report["threads_after_stop"] == "[]",
                  f"serve ({mode}) left threads alive: {stopped[-1]}")
            runs[mode] = report
    cost = {label: {"p50_ms": runs["on"]["load"][label]["p50_ms"]
                    - runs["off"]["load"][label]["p50_ms"],
                    "frames_per_s": runs["on"]["load"][label]["frames_per_s"]
                    - runs["off"]["load"][label]["frames_per_s"]}
            for label in runs["off"]["load"]}
    emit("telemetry_plane", card, flags=list(PLANE_FLAGS), clients=PLANE_CLIENTS,
         window_s=PLANE_WINDOW_S, frame_hw=list(FRAME_HW), scan_points=list(SCAN_POINTS),
         runs=runs, telemetry_cost=cost, wall_s=time.perf_counter() - t_phase)


def plane_checks(lines: list, address: str, workload: list, metric_types, opstats) -> dict:
    """The telemetry run's reads of its endpoint (run_telemetry_plane)."""
    deadline = time.perf_counter() + 30
    port = None
    while port is None and time.perf_counter() < deadline:
        port = next((int(line.split(":")[1].split()[0]) for line in lines
                     if line.startswith("telemetry on :")), None)
        if port is None:
            time.sleep(0.1)
    check(port is not None, f"serve printed no telemetry port: {lines[-5:]}")
    base = f"http://127.0.0.1:{port}"
    profile = plane_profile(base, address, workload)
    import urllib.request

    with urllib.request.urlopen(base + "/metrics", timeout=60) as resp:
        text = resp.read().decode()
    missing = [n for n, kind in metric_types.items() if f"# TYPE {n} {kind}" not in text]
    check(not missing, f"/metrics lacks {missing}")
    code, snap = http_json(base + "/snapshot")
    check(code == 200, f"/snapshot answered {code}")
    launches = snap["device_time"]["launches"]
    answered = {}
    for model in PLANE_ENTRIES:
        count = snap["histograms"][f"{model}|e2e"]["count"]
        check(count == launches.get(model) and count > 0,
              f"{model}: e2e histogram count {count}, launches {launches.get(model)}")
        answered[model] = count
    slo = snap["slo"]
    check(slo["met"] + slo["missed"] == sum(answered.values()),
          f"SLO met {slo['met']} + missed {slo['missed']} != answered {answered}")
    busy = snap["device_time"]["busy_fraction"]
    check(0 < busy <= 1, f"busy share {busy}")
    code, history = http_json(base + "/history")
    seen = {key.split("|")[0] for e in history["snapshots"] for key in e["models"]}
    check(code == 200 and set(PLANE_ENTRIES) <= seen, f"/history models {seen}")
    sampler = snap["sampler"]
    check(sampler["failures"] == 0 and sampler["captures"] > 0, f"sampler {sampler}")
    # the sampler's last window (a later profiler session of the process)
    sampled = {}
    for row in snap["op_sample"]["rows"]:
        fn = opstats.kernel_function(row["op"])
        if fn in opstats.KERNEL_STAGES:
            sampled.setdefault(row.get("model") or "unattributed", []).append(fn)
    code, tail = http_json(base + "/traces?slo_violations=1&n=5")
    check(code == 200, f"/traces?slo_violations=1 answered {code}")
    return {
        "answered": answered, "attainment": slo["met"] / max(1, slo["met"] + slo["missed"]),
        "slo": {"met": slo["met"], "missed": slo["missed"], "tail_retained": slo["tail_retained"]},
        "busy_fraction": busy, "device_time_s": snap["device_time"]["device_seconds"],
        "compile": snap["compile"], "memory": snap["memory"],
        "sampler": sampler, "sampler_last_window_kernels": sampled,
        "history_entries": len(history["snapshots"]), "profile": profile,
        "quantiles_ms": {key: {"p50": 1e3 * _hist_q(h, 0.5), "p99": 1e3 * _hist_q(h, 0.99),
                               "count": h["count"]}
                         for key, h in snap["histograms"].items()},
    }


def _hist_q(h, q: float) -> float:
    from triton_client_tpu_torch.obs.histogram import quantile_from_snapshot

    return quantile_from_snapshot(h or {}, q)



# phase 37: four examples/ entries behind `serve`'s wiring with a lifecycle;
# yolov5_crop pinned in its tenant, the rest in a second tenant
LIFECYCLE_ENTRIES = ("yolov5_crop", "yolov5l_crop", "pointpillar_kitti", "second_iou")
LIFECYCLE_PINNED = "yolov5_crop"
LIFECYCLE_REQUESTS = 6  # a model, interleaved from a seed
LIFECYCLE_FLEET_INFLIGHT = 4
# the kernels (COUNTER_NAMES) each entry's request launches once
LIFECYCLE_KERNELS = {
    "yolov5_crop": ("decode_nms_2d",),
    "yolov5l_crop": ("decode_nms_2d",),
    "pointpillar_kitti": ("residual_decode_3d", "suppress_pack_3d", "residual_decode_3d_gathered"),
    "second_iou": ("residual_decode_3d", "suppress_pack_3d", "residual_decode_3d_gathered",
                   "segment_mean"),
}


def lifecycle_repository(tmp: pathlib.Path) -> pathlib.Path:
    """Copies of the four entries' ``config.yaml`` (seeded weights at build),
    the 2D ones at conf 0.05: seeded weights keep nothing at 0.3."""
    for name in LIFECYCLE_ENTRIES:
        (tmp / name).mkdir()
        text = (ROOT / "examples" / name / "config.yaml").read_text()
        if name.startswith("yolov5"):
            check("conf_thresh: 0.3" in text, f"examples/{name} changed its conf_thresh")
            text = text.replace("conf_thresh: 0.3", "conf_thresh: 0.05")
        (tmp / name / "config.yaml").write_text(text)
    return tmp


def lifecycle_inputs(spec_extra: dict, name: str, seed: int) -> dict:
    """One request's inputs: a seeded FP32 frame at the entry's input size
    (the key its page-in captures), or a seeded 20,000-point scan padded to
    the entry's buckets."""
    from triton_client_tpu_torch.pipelines.detect3d import prepare_points

    rng = np.random.default_rng(seed)
    if name.startswith("yolov5"):
        h, w = spec_extra["model_input_hw"]
        return {"images": rng.integers(0, 256, (1, h, w, 3)).astype(np.float32)}
    pc = uniform_clouds(seed, (0.0, -39.68, -3.0, 69.12, 39.68, 1.0), SCAN_POINTS[0], 1)[0]
    padded, m = prepare_points(pc, 4, spec_extra["point_buckets"], spec_extra["z_offset"])
    return {"points": padded, "num_points": np.asarray(m, np.int32)}


def memory_reading() -> dict:
    """The card's reserved and allocated bytes (the caching allocator) and
    its free bytes (``mem_get_info``), after a synchronize."""
    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats()
    free, total = torch.cuda.mem_get_info()
    return {"reserved": int(stats["reserved_bytes.all.current"]),
            "allocated": int(stats["allocated_bytes.all.current"]), "free": int(free),
            "total": int(total)}


def memory_change(before: dict, after: dict) -> dict:
    """after - before of each reading: an eviction that frees memory reads
    a negative reserved and a positive free."""
    return {k: after[k] - before[k] for k in ("reserved", "allocated", "free")}


def lifecycle_server(root: pathlib.Path, flags: list[str]):
    """``serve``'s wiring in this process (cli/serve.build_server), started
    on a loopback port: (server, its repository, a client of it)."""
    from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel
    from triton_client_tpu_torch.cli import serve

    args = serve.parser().parse_args(["-r", str(root), "-a", "127.0.0.1:0", "--uds", "off",
                                      "--max-workers", "4", *flags])
    server = serve.build_server(args)
    server.start()
    return server, server.channel._repository, GRPCChannel(f"127.0.0.1:{server.port}",
                                                           timeout_s=300.0)


def timed_hooks(lifecycle) -> dict:
    """Wrap the manager's page-in and page-out hooks to time each event
    (host clock, the card synchronized after): {"warm": [(model, s)],
    "evict": [(model, s)]}."""
    events: dict = {"warm": [], "evict": []}
    warmer, evictor = lifecycle._warmer, lifecycle._evictor

    def timed(kind, hook):
        def run(name, version):
            t0 = time.perf_counter()
            hook(name, version)
            torch.cuda.synchronize()
            events[kind].append((name, time.perf_counter() - t0))
        return run

    lifecycle.set_hooks(warmer=timed("warm", warmer), evictor=timed("evict", evictor))
    return events


def promote_beside_serving(server, lifecycle, requests, want, promotions: int = 2) -> dict:
    """``promotions`` cold models promoted, one after the other, through the
    main client while a second client keeps the pinned model busy: each
    promotion's capture, and the eviction and ``empty_cache`` it makes, run
    beside the pinned model's replays on other RPC threads. Every answer of
    both is held bitwise against the unbudgeted server's, and resident
    bytes against the budget. Returns the promotions' walls, the busy
    client's requests and how many of them overlapped a promotion."""
    import threading

    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel

    def bitwise(got, ref) -> bool:
        return set(got) == set(ref) and all(
            np.asarray(got[k]).tobytes() == np.asarray(ref[k]).tobytes() for k in ref)

    address = f"127.0.0.1:{server.port}"
    pinned = [(inputs, ref) for (name, inputs), ref in zip(requests, want)
              if name == LIFECYCLE_PINNED][:2]
    stop, busy, errors = threading.Event(), [], []
    busy_client = GRPCChannel(address, timeout_s=300.0)
    main_client = GRPCChannel(address, timeout_s=300.0)

    def keep_busy():
        i = 0
        while not stop.is_set() and i < 5000:
            inputs, ref = pinned[i % len(pinned)]
            t0 = time.perf_counter()
            try:
                got = busy_client.do_inference(InferRequest(LIFECYCLE_PINNED, inputs)).outputs
            except Exception as e:  # re-raised below, on the phase's thread
                errors.append(e)
                return
            busy.append((t0, time.perf_counter(), bitwise(got, ref)))
            i += 1

    worker = threading.Thread(target=keep_busy, daemon=True)
    windows, promoted = [], []
    try:
        worker.start()
        bound = time.perf_counter() + 60.0
        while len(busy) < 3 and not errors and time.perf_counter() < bound:
            time.sleep(0.01)
        for _ in range(promotions):
            s = lifecycle.stats()
            cold = [n for n in LIFECYCLE_ENTRIES if s["models"][f"{n}:1"]["state"] == "cold"]
            check(bool(cold), f"no cold model to promote: {s['models']}")
            name = cold[0]
            inputs, ref = next((i, r) for (n, i), r in zip(requests, want) if n == name)
            t0 = time.perf_counter()
            got = main_client.do_inference(InferRequest(name, inputs)).outputs
            windows.append((t0, time.perf_counter()))
            promoted.append(name)
            check(bitwise(got, ref), f"{name}: promoted beside a serving model, its answer differs")
            s = lifecycle.stats()
            check(s["models"][f"{name}:1"]["state"] == "warm"
                  and s["resident_bytes"] <= lifecycle.budget_bytes,
                  f"{name} beside a serving model: {s['models'][f'{name}:1']}, resident "
                  f"{s['resident_bytes']} of {lifecycle.budget_bytes}")
    finally:
        stop.set()
        worker.join(timeout=60.0)
        busy_client.close()
        main_client.close()
    check(not worker.is_alive(), "the busy client did not stop")
    if errors:
        raise errors[0]
    check(all(ok for _, _, ok in busy), "the pinned model's answer changed beside a promotion")
    overlapping = [sum(1 for b0, b1, _ in busy if b0 < w1 and b1 > w0) for w0, w1 in windows]
    check(all(n >= 1 for n in overlapping),
          f"no request of the pinned model overlapped a promotion: {overlapping}")
    check(lifecycle.stats()["models"][f"{LIFECYCLE_PINNED}:1"]["evictions"] == 0,
          f"the pinned {LIFECYCLE_PINNED} was evicted")
    return {"promoted": promoted, "promotion_request_ms": [1e3 * (w1 - w0) for w0, w1 in windows],
            "busy_requests": len(busy), "busy_overlapping": overlapping,
            "busy_p50_ms": 1e3 * float(np.percentile([b1 - b0 for b0, b1, _ in busy], 50))}


def run_lifecycle(card: str, counters) -> dict:
    """Phase 37: the model lifecycle and tenant plane on the card.
    ``serve``'s wiring in this process over copies of examples/yolov5_crop,
    yolov5l_crop (both at conf 0.05), pointpillar_kitti and second_iou, with
    a ``tenants.yaml`` that pins yolov5_crop in a tenant with a quota and
    puts the other three in a tenant with ``max_inflight``. First an
    unbudgeted server (``--tenants`` only: models page in and never out)
    answers a seeded schedule of 24 requests, 6 a model interleaved, through
    a loopback client and gives each model's measured cost
    (``param_bytes`` + its graph pools). It is stopped and freed; then a
    server with ``--hbm-budget`` set so that the two largest costs fit and
    the three largest do not (``--metrics-port auto``, ``--admission``)
    answers the same schedule. Held: every answer bitwise equal to the
    unbudgeted server's; promotions >= 5, evictions >= 3; the pinned model
    never evicted; resident bytes within the budget after every request;
    every COLD model's live graph-pool bytes and keys 0; /snapshot and
    /metrics carrying the lifecycle; two cold models promoted while a
    second client keeps the pinned model busy (their captures, and the
    evictions and ``empty_cache`` they make, beside its replays), every
    answer of both bitwise equal to the unbudgeted server's and resident
    bytes within the budget; kernels 1, 3, 4 and 5 bitwise equal to
    their plain versions on the phase's own inputs; each kernel's launches
    in the schedule equal to the replays' plus the captures' warmup calls
    (``runtime/graphs.WARMUP_CALLS`` a capture) plus the ledger's one
    measuring run a model. Then the page-out's two steps apart (the
    graphs' release, then ``empty_cache``) and a whole eviction, the card's
    memory read around each. Lines lifecycle_costs and lifecycle."""
    import gc
    import tempfile
    import urllib.request

    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.staged import cast_wire_input
    from triton_client_tpu_torch.obs.histogram import quantile_from_snapshot
    from triton_client_tpu_torch.runtime import graphs
    from triton_client_tpu_torch.runtime.precision import host_tensor

    t_phase = time.perf_counter()
    names = list(LIFECYCLE_ENTRIES)
    order = [n for n in names for _ in range(LIFECYCLE_REQUESTS)]
    np.random.default_rng(37).shuffle(order)
    with tempfile.TemporaryDirectory(prefix="lifecycle_") as tmp:
        root = pathlib.Path(tmp) / "repo"
        root.mkdir()
        lifecycle_repository(root)
        tenants = pathlib.Path(tmp) / "tenants.yaml"

        def write_tenants(quota_mb: float) -> None:
            fleet = ", ".join(n for n in names if n != LIFECYCLE_PINNED)
            tenants.write_text(
                f"tenants:\n  lines:\n    share: 4\n    hbm_quota_mb: {quota_mb}\n"
                f"    models: [{LIFECYCLE_PINNED}]\n    pinned: [{LIFECYCLE_PINNED}]\n"
                f"  fleet:\n    share: 1\n    max_inflight: {LIFECYCLE_FLEET_INFLIGHT}\n"
                f"    models: [{fleet}]\n")

        # -- the unbudgeted server: the reference answers and the costs
        write_tenants(65536)
        mem_a0 = memory_reading()
        server, repo, client = lifecycle_server(root, ["--tenants", str(tenants)])
        requests = [(name, lifecycle_inputs(repo.get(name).spec.extra, name, 3700 + i))
                    for i, name in enumerate(order)]
        want = []
        try:
            for name, inputs in requests:
                want.append(client.do_inference(InferRequest(name, inputs)).outputs)
            stats_a = server.lifecycle.stats()
            costs = {m.split(":")[0]: row["cost_bytes"] for m, row in stats_a["models"].items()}
            pools = {n: repo.get(n).infer_fn.graph_stats()["pool_bytes"] for n in names}
            params = {n: int(repo.get(n).spec.extra.get("param_bytes", 0)) for n in names}
            check(stats_a["evictions"] == 0 and stats_a["promotions"] == len(names),
                  f"unbudgeted: {stats_a['promotions']} promotions, {stats_a['evictions']} "
                  "evictions")
            check(all(costs[n] == params[n] + pools[n] > params[n] for n in names),
                  f"costs {costs} are not param_bytes {params} + pool bytes {pools}")
            mem_a1 = memory_reading()
        finally:
            client.close()
            server.stop()
        del server, repo, client
        gc.collect()
        torch.cuda.empty_cache()
        ranked = sorted(costs.values(), reverse=True)
        budget = ranked[0] + ranked[1] + ranked[2] // 2
        budget_mb = budget / (1 << 20)
        emit("lifecycle_costs", card, costs=costs, param_bytes=params, pool_bytes=pools,
             budget_bytes=budget, memory_unbudgeted=memory_change(mem_a0, mem_a1),
             memory_after_free=memory_change(mem_a0, memory_reading()))

        # -- the budgeted server
        write_tenants(costs[LIFECYCLE_PINNED] * 1.5 / (1 << 20))
        mem_b0 = memory_reading()
        server, repo, client = lifecycle_server(root, [
            "--hbm-budget", repr(budget_mb), "--tenants", str(tenants), "--metrics-port", "auto",
            "--admission", "64"])
        lifecycle, channel = server.lifecycle, server.channel
        events = timed_hooks(lifecycle)
        try:
            check(abs(lifecycle.budget_bytes - budget) <= 1,
                  f"budget {lifecycle.budget_bytes} != {budget}")
            graph_stats = {n: repo.get(n).infer_fn.graph_stats for n in names}
            before = {n: graph_stats[n]() for n in names}
            measured0 = set(channel._cost_measured)
            torch.cuda.synchronize()
            for counter in counters:
                counter.reset()
            latencies = {"cold": [], "warm": []}
            max_resident = 0
            for (name, inputs), ref in zip(requests, want):
                promoted = lifecycle.stats()["models"].get(f"{name}:1", {}).get("promotions", 0)
                t0 = time.perf_counter()
                got = client.do_inference(InferRequest(name, inputs)).outputs
                wall = time.perf_counter() - t0
                s = lifecycle.stats()
                cold = s["models"][f"{name}:1"]["promotions"] > promoted
                latencies["cold" if cold else "warm"].append((name, wall))
                check(set(got) == set(ref) and all(
                    np.asarray(got[k]).tobytes() == np.asarray(ref[k]).tobytes() for k in ref),
                    f"{name}: a paged answer differs from the unbudgeted server's")
                max_resident = max(max_resident, s["resident_bytes"])
                check(s["resident_bytes"] <= budget,
                      f"resident {s['resident_bytes']} over the budget {budget}")
                for model, row in s["models"].items():
                    if row["state"] == "cold":
                        g = graph_stats[model.split(":")[0]]()
                        check(g["pool_bytes"] == 0 and g["keys"] == 0,
                              f"{model} is cold and holds graphs: {g}")
            torch.cuda.synchronize()
            launches = dict(zip(COUNTER_NAMES, (c.count for c in counters)))
            after = {n: graph_stats[n]() for n in names}
            measured = set(channel._cost_measured) - measured0
            s = lifecycle.stats()
            check(s["promotions"] >= 5 and s["evictions"] >= 3,
                  f"{s['promotions']} promotions, {s['evictions']} evictions")
            check(s["models"][f"{LIFECYCLE_PINNED}:1"]["evictions"] == 0,
                  f"the pinned {LIFECYCLE_PINNED} was evicted")
            # launches: replays, the captures' eager warmup calls, the
            # ledger's one measuring run a model
            split = {}
            for kernel in sorted({k for ks in LIFECYCLE_KERNELS.values() for k in ks}):
                users = [n for n in names if kernel in LIFECYCLE_KERNELS[n]]
                replay = sum(after[n]["replays"] - before[n]["replays"] for n in users)
                capture = sum(graphs.WARMUP_CALLS * (after[n]["captures"] - before[n]["captures"])
                              for n in users)
                cost = sum((n, "1") in measured for n in users)
                split[kernel] = {"total": launches[kernel], "replay": replay,
                                 "capture_warmup": capture, "ledger_cost": cost}
                check(launches[kernel] == replay + capture + cost,
                      f"{kernel}: {launches[kernel]} launches != {replay} replays + {capture} "
                      f"capture warmups + {cost} ledger runs")
            check(all(launches[k] == 0 for k in ("greedy_nms", "segment_sum")),
                  f"launches off the path: {launches}")
            mem_b1 = memory_reading()
            # the telemetry plane reads the manager
            base = f"http://127.0.0.1:{server.metrics_port}"
            code, snap = http_json(base + "/snapshot")
            check(code == 200 and snap["lifecycle"]["budget_bytes"] == lifecycle.budget_bytes
                  and snap["lifecycle"]["promotion_latency"]["count"] == s["promotions"],
                  f"/snapshot lifecycle: {code} {snap and snap.get('lifecycle')}")
            with urllib.request.urlopen(base + "/metrics", timeout=60) as resp:
                text = resp.read().decode()
            for line in ('tpu_serving_tenant_hbm_bytes{tenant="fleet"}',
                         'tpu_serving_tenant_hbm_bytes{tenant="lines"}',
                         "tpu_serving_promotion_seconds_bucket",
                         'tpu_serving_lifecycle_models{state="warm"}'):
                check(line in text, f"/metrics lacks {line}")
            check(server.admission.stats()["tenant_inflight"] == {"lines": 0, "fleet": 0},
                  f"tenant in-flight {server.admission.stats()['tenant_inflight']}")
            beside = promote_beside_serving(server, lifecycle, requests, want)
            # kernels 1, 3, 4 and 5 against their plain versions, on the
            # phase's own first input of each model (eager, outside the window)
            shapes = {}
            for name in names:
                model = repo.get(name)
                inputs = next(i for n, i in requests if n == name)
                on_card = {k: host_tensor(np.require(cast_wire_input(model, k, np.asarray(v)),
                                                     requirements="C")).cuda()
                           for k, v in inputs.items()}
                _, calls = recorded_kernel_calls(lambda: model.member_device_fn(on_card))
                # kernel 3 records under its gathered form
                check(set(calls) == set(LIFECYCLE_KERNELS[name]) - {"residual_decode_3d"},
                      f"{name}: the eager run called {sorted(calls)}")
                shapes[name] = kernels_equal_plain(calls, f"lifecycle_{name}")
            # the page-out's two steps apart, then whole: the graphs'
            # release alone, empty_cache after it, and an eviction (both)
            victim = "pointpillar_kitti"
            lifecycle.prefetch(victim)
            pool = graph_stats[victim]()["pool_bytes"]
            r0 = memory_reading()
            t0 = time.perf_counter()
            repo.get(victim).infer_fn.release_graphs()
            torch.cuda.synchronize()
            release_s = time.perf_counter() - t0
            r1 = memory_reading()
            t0 = time.perf_counter()
            graphs.empty_cache()
            empty_s = time.perf_counter() - t0
            r2 = memory_reading()
            check(lifecycle.evict(victim), f"{victim} did not evict")
            lifecycle.prefetch(victim)
            r3 = memory_reading()
            t0 = time.perf_counter()
            check(lifecycle.evict(victim), f"{victim} did not evict")
            evict_s = time.perf_counter() - t0
            r4 = memory_reading()
            page_out = {
                "pool_bytes": pool,
                "release": {"s": release_s, "change": memory_change(r0, r1)},
                "empty_cache_after_release": {"s": empty_s, "change": memory_change(r1, r2)},
                "evict": {"s": evict_s, "change": memory_change(r3, r4)},
            }
        finally:
            client.close()
            server.stop()
    warm_s = [t for _, t in events["warm"]]
    evict_s = [t for _, t in events["evict"]]
    hist = s["promotion_latency"]
    emit("lifecycle", card, entries=names, order=order, budget_bytes=budget,
         max_resident_bytes=max_resident, promotions=s["promotions"], evictions=s["evictions"],
         models={m: {k: row[k] for k in ("state", "cost_bytes", "tenant", "pinned", "promotions",
                                         "evictions")} for m, row in s["models"].items()},
         promotion_ms={"p50_hist": 1e3 * quantile_from_snapshot(hist, 0.5),
                       "p99_hist": 1e3 * quantile_from_snapshot(hist, 0.99),
                       "mean": 1e3 * hist["sum"] / max(1, hist["count"]), "count": hist["count"]},
         recapture_ms={"p50": 1e3 * float(np.percentile(warm_s, 50)),
                       "p99": 1e3 * float(np.percentile(warm_s, 99)), "n": len(warm_s),
                       "by_model": {n: [1e3 * t for m, t in events["warm"] if m == n]
                                    for n in names}},
         evict_ms={"p50": 1e3 * float(np.percentile(evict_s, 50)), "n": len(evict_s)},
         request_p50_ms={kind: 1e3 * float(np.percentile([t for _, t in rows], 50))
                         for kind, rows in latencies.items() if rows},
         request_p50_ms_by_model={n: {kind: 1e3 * float(np.percentile(
             [t for m, t in rows if m == n], 50)) for kind, rows in latencies.items()
             if any(m == n for m, _ in rows)} for n in names},
         launches=split, kernel_shapes=shapes, page_out=page_out, beside_serving=beside,
         memory={"unbudgeted": memory_change(mem_a0, mem_a1),
                 "budgeted": memory_change(mem_b0, mem_b1)},
         wall_s=time.perf_counter() - t_phase)
    return {k: {"capture": v["capture_warmup"], "replay": v["replay"]} for k, v in split.items()}


# phase 38: streaming sessions and the tracker on the card
SESSION_FRAMES, SESSION_ROWS, SESSION_GROUP = 40, 128, 4  # the tracker drive
SESSION_CP_STREAMS, SESSION_CP_FRAMES, SESSION_CP_POINTS = 4, 12, 200000
SESSION_2D_STREAMS, SESSION_2D_FRAMES = 2, 6
SESSION_ECHO_STREAMS, SESSION_ECHO_FRAMES, SESSION_ECHO_FPS = 8, 30, 10.0
SESSION_TIMED = 50  # captured steps timed a group size; CenterPoint requests a leg: 30
SESSION_TOL = 1e-5  # float leaves, card against the plain tracker
SESSION_EXACT = ("track_assign", "det_track_ids", "track_ids", "tracks_valid")
SESSION_INT_STATE = ("tid", "age", "hits", "next_id", "frame", "births", "deaths")


def tracker_drive(seed: int, frames: int = SESSION_FRAMES, rows: int = SESSION_ROWS,
                  objects: int = 72) -> list[tuple[np.ndarray, np.ndarray]]:
    """A seeded drive of CenterPoint-shaped rows (``rows`` x 11, the packed
    ``[box7, vx, vy, score, label]``): ``objects`` constant-velocity movers
    over the nuScenes range, some in close pairs, with noisy positions,
    scores that dip below the stage-1 split and below the low one, leavers
    and late arrivals, clutter, invalid padding rows, and the row order
    shuffled every frame."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-45.0, 45.0, (objects, 2)).astype(np.float32)
    pos[1::6] = pos[0::6][: len(pos[1::6])] + rng.uniform(-1.5, 1.5, (len(pos[1::6]), 2))
    vel = rng.uniform(-1.2, 1.2, (objects, 2)).astype(np.float32)
    born = rng.integers(0, frames // 2, objects) * (rng.random(objects) < 0.3)
    gone = np.where(rng.random(objects) < 0.2, rng.integers(frames // 3, frames, objects), frames)
    out = []
    for k in range(frames):
        live = np.flatnonzero((born <= k) & (k < gone))[:rows - 8]
        det = np.zeros((rows, 11), np.float32)
        n = len(live)
        det[:n, 0:2] = pos[live] + k * vel[live] + rng.normal(0.0, 0.08, (n, 2))
        det[:n, 2] = rng.normal(0.0, 0.2, n)
        det[:n, 3:6] = (4.2, 1.9, 1.6)
        det[:n, 6] = rng.uniform(-np.pi, np.pi, n)
        det[:n, 7:9] = vel[live] + rng.normal(0.0, 0.1, (n, 2))
        det[:n, 9] = np.where(rng.random(n) < 0.15, rng.uniform(0.1, 0.5, n),
                              rng.uniform(0.5, 0.95, n))
        det[:n, 9] = np.where(rng.random(n) < 0.05, 0.05, det[:n, 9])
        det[:n, 10] = rng.integers(0, 10, n)
        clutter = min(8, rows - n)
        det[n:n + clutter, 0:2] = rng.uniform(-50.0, 50.0, (clutter, 2))
        det[n:n + clutter, 9] = rng.uniform(0.05, 0.3, clutter)
        valid = np.zeros(rows, bool)
        valid[:n + clutter] = True
        order = rng.permutation(rows)
        out.append((det[order], valid[order]))
    return out


def tracker_compare(card_state, card_out, plain_state, plain_out, label: str, keys) -> float:
    """The card's tracker state and outputs against the plain tracker's:
    integers and flags bitwise, floats within SESSION_TOL. Returns the
    largest float difference."""
    worst = 0.0
    for key in keys:
        check(torch.equal(card_out[key].cpu(), plain_out[key]), f"{label}: {key} differs")
    for key in SESSION_INT_STATE:
        check(torch.equal(card_state[key].cpu(), plain_state[key]), f"{label}: state {key}")
    for key in ("mean", "cov", "box", "tracks", "innovation"):
        got = (card_state.get(key) if key in card_state else card_out.get(key))
        want = (plain_state.get(key) if key in plain_state else plain_out.get(key))
        if got is None or want is None:
            continue
        got = got.cpu()
        check(bool((torch.isnan(got) == torch.isnan(want)).all()), f"{label}: {key} NaN")
        diff = (got - want).abs().nan_to_num(0.0)
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
    check(worst <= SESSION_TOL, f"{label}: float leaves differ by {worst}")
    return worst


def tracker_on_card(dev: torch.device) -> dict:
    """Part 1 of phase 38: the captured tracker (``ops/tracking.TrackerStep``,
    TrackerConfig()) on the card against the plain tracker on the CPU, frame
    by frame over seeded drives: the single step, the group step at
    SESSION_GROUP cameras (each camera against its own plain step), coasts
    between keyframes, a frame with equal affinities and one with a NaN
    centre; greedy_assign's card form against its plain form on a tied and
    a NaN matrix; the session frame bracket under
    ``torch.cuda.set_sync_debug_mode("error")``. Returns what it measured."""
    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.ops import tracking
    from triton_client_tpu_torch.runtime.sessions import SessionManager

    cfg = tracking.TrackerConfig()
    on = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    worst = {}

    # the single step, with coasts and the tie and NaN frames
    drive = tracker_drive(380)
    det, valid = drive[7]
    tie = det.copy()
    live = np.flatnonzero(valid & (det[:, 9] >= 0.5))
    tie[live[1], 0:2] = tie[live[0], 0:2]  # two rows at one centre: equal affinities
    drive[7] = (tie, valid)
    nan = drive[12][0].copy()
    nan[np.flatnonzero(drive[12][1])[3], 0] = np.nan
    drive[12] = (nan, drive[12][1])
    step, coast = tracking.make_step(cfg), tracking.make_coast_step(cfg)
    card = {k: v.to(dev) for k, v in tracking.init_state(cfg, 11).items()}
    plain = tracking.init_state(cfg, 11)
    worst["single"] = 0.0
    for k, (det, valid) in enumerate(drive):
        if k % 5 == 4:
            card, cout = coast(card)
            plain, pout = tracking.reference_coast(cfg, plain)
            keys = tracking.COAST_OUTPUT_KEYS[1:]
        else:
            card, cout = step(card, on(det), on(valid))
            plain, pout = tracking.reference_step(cfg, plain, det, valid)
            keys = SESSION_EXACT
        worst["single"] = max(worst["single"], tracker_compare(
            card, cout, plain, pout, f"tracker frame {k}", keys))
    births = int(plain["births"])
    check(births > 20 and int(plain["deaths"]) > 0, f"the drive made {births} births")

    # the group step: each camera against its own plain step
    group_step = tracking.make_group_step(cfg)
    drives = [tracker_drive(381 + c) for c in range(SESSION_GROUP)]
    span = (1 << 16) // SESSION_GROUP
    bases = [tracking.init_state(cfg, 11) for _ in range(SESSION_GROUP)]
    for c, b in enumerate(bases):
        b["next_id"] = torch.tensor(1 + c * span, dtype=torch.int32)
    gcard = {k: torch.stack([b[k] for b in bases]).to(dev) for k in tracking.STATE_KEYS}
    worst["group"] = 0.0
    for k in range(SESSION_FRAMES):
        dets = np.stack([d[k][0] for d in drives])
        valids = np.stack([d[k][1] for d in drives])
        gcard, gout = group_step(gcard, on(dets), on(valids))
        for c in range(SESSION_GROUP):
            bases[c], pout = tracking.reference_step(cfg, bases[c], dets[c], valids[c])
            worst["group"] = max(worst["group"], tracker_compare(
                {key: v[c] for key, v in gcard.items()}, {key: v[c] for key, v in gout.items()},
                bases[c], pout, f"group frame {k} camera {c}", SESSION_EXACT))

    # greedy_assign alone on a tied and a NaN affinity matrix
    tied = torch.full((64, SESSION_ROWS), -2.0)
    tied[::3, ::5] = -1.0
    nan_cost = torch.randn(64, SESSION_ROWS, generator=torch.Generator().manual_seed(38))
    nan_cost[5, 7] = float("nan")
    for name, cost in (("tie", tied), ("nan", nan_cost)):
        want = tracking.greedy_assign(cost, 64, plain=True)
        got = tracking.greedy_assign(cost.to(dev), 64)
        check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
              f"greedy_assign's card form differs on the {name} matrix")

    # the frame bracket: advance/release never wait for the card once warm
    manager = SessionManager(max_sessions=4)
    frames = [(on(d), on(v)) for d, v in drive[:12]]
    groups = [(on(np.stack([d[k][0] for d in drives])), on(np.stack([d[k][1] for d in drives])))
              for k in range(4)]
    for sid, (d, v) in (("r1", frames[0]), ("rg", groups[0])):
        manager.advance(InferRequest("m", {}, sequence_id=sid, sequence_start=True),
                        {"detections": d, "valid": v})
        manager.release(sid)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for (d, v), (gd, gv) in zip(frames[1:], groups[1:] * 4):
            manager.advance(InferRequest("m", {}, sequence_id="r1"), {"detections": d, "valid": v})
            manager.release("r1")
            manager.advance(InferRequest("m", {}, sequence_id="rg"),
                            {"detections": gd, "valid": gv})
            manager.release("rg")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    residency_frames = manager.stats()["frames_total"]
    check(residency_frames == 2 * len(frames), f"{residency_frames} frames in the bracket")

    # the captured step's time a frame: on the card's clock, CUDA events
    # around each call queued behind a sleep kernel (so the window holds the
    # input copies, the replay and the output clones, not the host issuing
    # them), and the call's host time
    timing = {}
    for g, fn, state, inputs in (
            (1, step, card, frames[1]), (SESSION_GROUP, group_step, gcard, groups[1])):
        dev_ms, host_ms = [], []
        cycles = 1 << 22  # about 2 ms at 1.98 GHz; grown while the host is slower
        while len(dev_ms) < SESSION_TIMED + 3:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            a.record()
            t0 = time.perf_counter()
            state, _ = fn(state, *inputs)
            host = 1e3 * (time.perf_counter() - t0)
            b.record()
            queued = not a.query()
            b.synchronize()
            if not queued:
                check(cycles < 1 << 28, "the card reached the timing event before the step "
                      "was queued, behind a sleep of 2^28 cycles")
                cycles *= 4
                continue
            host_ms.append(host)
            dev_ms.append(a.elapsed_time(b))
        timing[g] = {"device_us_median": 1e3 * float(np.median(dev_ms[3:])),
                     "device_us_p90": 1e3 * float(np.percentile(dev_ms[3:], 90)),
                     "host_us_median": 1e3 * float(np.median(host_ms[3:])),
                     "captures": fn.graphs.stats()["captures"]}
    return {"max_abs_err": worst, "drive_births": births, "residency_frames": residency_frames,
            "step_device_us": timing}


def sessions_repository(tmp: pathlib.Path) -> pathlib.Path:
    """The phase-38 repository root: examples/centerpoint_nusc with a seeded
    det3d-named ``1/weights.pth`` (phase 28's importer path) and
    examples/yolov5_crop at conf 0.05 (seeded at build)."""
    from triton_client_tpu_torch.runtime.disk_repository import _Entry

    root = tmp / "repo"
    (root / CP_ENTRY / "1").mkdir(parents=True)
    (root / CP_ENTRY / "config.yaml").write_bytes(
        (ROOT / "examples" / CP_ENTRY / "config.yaml").read_bytes())
    _, _, model = _Entry(root / CP_ENTRY, device="cpu")._build()
    torch.save({"state_dict": det3d_state(model)}, root / CP_ENTRY / "1" / "weights.pth")
    (root / "yolov5_crop").mkdir()
    text = (ROOT / "examples" / "yolov5_crop" / "config.yaml").read_text()
    check("conf_thresh: 0.3" in text, "examples/yolov5_crop changed its conf_thresh")
    (root / "yolov5_crop" / "config.yaml").write_text(
        text.replace("conf_thresh: 0.3", "conf_thresh: 0.05"))
    return root


class _Recorder:
    """A channel-shaped wrapper of a client that keeps every response's
    outputs by (sequence id, frame index): what ``run_streams`` returned to
    each stream, for the plain tracker's re-run."""

    def __init__(self, client) -> None:
        import threading

        self._client, self._lock = client, threading.Lock()
        self.frames: dict = {}

    def do_inference_async(self, request):
        raise NotImplementedError

    def do_inference(self, request):
        resp = self._client.do_inference(request)
        with self._lock:
            self.frames.setdefault(request.sequence_id, []).append(resp.outputs)
        return resp


def replay_matches_plain(recorded: dict, cfg, label: str) -> dict:
    """Each recorded stream's frames re-run through the plain tracker on the
    CPU, from a state whose ids start where the stream's first id says its
    session epoch starts: ids and associations bitwise, floats within
    SESSION_TOL. A response of a group of one is camera 0."""
    from triton_client_tpu_torch.ops import tracking
    from triton_client_tpu_torch.runtime.sessions import id_base_for

    worst, births, associated = 0.0, 0, 0
    for sid, outs in sorted(recorded.items()):
        ids = [int(t) for o in outs for t in np.asarray(o["track_ids"]).reshape(-1) if t > 0]
        base = id_base_for(0, (ids[0] >> 16) & 2047) if ids else 0
        det_dim = np.asarray(outs[0]["detections"]).shape[-1]
        state = tracking.init_state(cfg, det_dim, base)
        for k, o in enumerate(outs):
            check(set(tracking.OUTPUT_KEYS) <= set(o), f"{label} {sid} frame {k}: {sorted(o)}")
            # copies: a wire array is a read-only view of the response's bytes
            det, valid = np.array(o["detections"]), np.array(o["valid"])
            got = {key: torch.from_numpy(np.array(o[key])) for key in tracking.OUTPUT_KEYS}
            if det.ndim == 3:  # a group of one
                check(det.shape[0] == 1, f"{label}: a group of {det.shape[0]}")
                det, valid = det[0], valid[0]
                got = {key: v[0] for key, v in got.items()}
            state, want = tracking.reference_step(cfg, state, det, valid)
            for key in SESSION_EXACT:
                check(torch.equal(got[key], want[key]), f"{label} {sid} frame {k}: {key}")
            for key in ("tracks", "innovation"):
                diff = (got[key] - want[key]).abs().nan_to_num(0.0)
                worst = max(worst, float(diff.max()))
            associated += int((want["track_assign"] >= 0).sum())
        births += int(state["births"])
    check(worst <= SESSION_TOL, f"{label}: served tracks differ from the plain by {worst}")
    return {"max_abs_err": worst, "births": births, "associations": associated}


def run_sessions(card: str, counters) -> dict:
    """Phase 38: streaming sessions (runtime/sessions.py) and the tracker
    (ops/tracking.py) on the card.

    1. The captured tracker against the plain one (``tracker_on_card``).
    2. ``serve --max-sessions 16`` (its wiring in this process) over a disk
       repository of examples/centerpoint_nusc (seeded det3d weights, phase
       28's importer) and examples/yolov5_crop (conf 0.05):
       ``utils/loadgen.run_streams(realtime=False)`` replays 4 streams x 12
       seeded clouds at the 262,144 bucket (each stream one cloud drifting
       0.2 m a frame) and 2 streams x 6 seeded 512x512 frames over loopback.
       Held: every frame answered with OUTPUT_KEYS; the plain tracker re-run
       on the CPU over the detections and valid masks the responses carry
       gives their ids and associations bitwise (yolov5_crop: a group of
       one, velocity narrowed to None); one kernel-4 launch a CenterPoint
       frame, one kernel-1 launch a yolov5_crop frame, no other kernel.
    3. The echo drive (JAX's ``streaming_sessions`` row on the port): 8
       streams of ``synthetic_stream(n_frames=30, fps=10, n_objects=4)``
       at real time against an echo model with TrackerConfig(max_tracks=32):
       goodput 1.0, no alias, no ID switch, 240 frames and 8 ended sessions,
       and the plain tracker re-run over the responses bitwise, as in 2.
    4. Timing: the captured step's device us a frame at G = 1 and G = 4, and
       a CenterPoint request's p50 through the channel with and without a
       sequence_id, in turns.
    Line sessions. Returns kernels 1 and 4's launches in part 2."""
    import tempfile

    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.cuda_channel import CUDAChannel
    from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel
    from triton_client_tpu_torch.cli import serve as serve_cli
    from triton_client_tpu_torch.config import ModelSpec, TensorSpec
    from triton_client_tpu_torch.ops import tracking
    from triton_client_tpu_torch.pipelines.detect3d import prepare_points
    from triton_client_tpu_torch.runtime.repository import ModelRepository
    from triton_client_tpu_torch.runtime.server import InferenceServer
    from triton_client_tpu_torch.runtime.sessions import SessionManager
    from triton_client_tpu_torch.utils import loadgen

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    result = {"tracker": tracker_on_card(dev)}
    t_tracker = time.perf_counter() - t_phase

    # -- 2. full width through serve --------------------------------------------
    with tempfile.TemporaryDirectory(prefix="sessions_") as tmp:
        cwd = os.getcwd()
        os.chdir(ROOT)  # the entries name data/ files relative to the checkout
        try:
            root = sessions_repository(pathlib.Path(tmp))
            args = serve_cli.parser().parse_args(
                ["-r", str(root), "-a", "127.0.0.1:0", "--uds", "off", "--warmup",
                 "--max-workers", "8", "--max-sessions", "16"])
            server = serve_cli.build_server(args)
        finally:
            os.chdir(cwd)
        server.start()
        channel = server.channel
        manager = channel.sessions
        client = GRPCChannel(f"127.0.0.1:{server.port}", timeout_s=300.0)
        try:
            check(manager is not None and manager.stats()["max_sessions"] == 16,
                  "serve --max-sessions 16 attached no manager")
            cp_extra = channel._repository.get(CP_ENTRY).spec.extra
            y_hw = channel._repository.get("yolov5_crop").spec.extra["model_input_hw"]

            def cloud(stream: int, k: int) -> dict:
                pc = uniform_clouds(3800 + stream, NUSC_RANGE, SESSION_CP_POINTS, 1)[0]
                pc[:, 0] += 0.2 * k
                padded, m = prepare_points(pc, 5, cp_extra["point_buckets"],
                                           cp_extra.get("z_offset", 0.0))
                return {"points": padded, "num_points": np.asarray(m, np.int32)}

            def image(stream: int, k: int) -> dict:
                rng = np.random.default_rng(3900 + 100 * stream + k)
                return {"images": rng.integers(0, 256, (1, *y_hw, 3)).astype(np.float32)}

            legs = {CP_ENTRY: (cloud, SESSION_CP_STREAMS, SESSION_CP_FRAMES, "suppress_pack_3d"),
                    "yolov5_crop": (image, SESSION_2D_STREAMS, SESSION_2D_FRAMES,
                                    "decode_nms_2d")}
            for name, (make, _, _, _) in legs.items():  # warm: the model and the tracker
                client.do_inference(InferRequest(name, make(0, 0)))
                for k in range(2):
                    client.do_inference(InferRequest(name, make(0, k), sequence_id=f"warm-{name}",
                                                     sequence_start=k == 0, sequence_end=k == 1))
            served, launches = {}, {}
            for name, (make, streams, frames, kernel) in legs.items():
                frames_in = {i: [(0.0, make(i, k)) for k in range(frames)]
                             for i in range(streams)}
                recorder = _Recorder(client)
                torch.cuda.synchronize()
                for counter in counters:
                    counter.reset()
                res = loadgen.run_streams(recorder, name, streams, lambda i: frames_in[i],
                                          deadline_s=300.0, stream_id_prefix=name,
                                          realtime=False)
                torch.cuda.synchronize()
                counts = dict(zip(COUNTER_NAMES, (c.count for c in counters)))
                want = {c: 0 for c in COUNTER_NAMES}
                want[kernel] = streams * frames
                check(counts == want, f"{name} session launches {counts}, want {want}")
                check(res.frames_ok == res.frames_sent == streams * frames and res.goodput == 1.0,
                      f"{name}: {res.frames_ok} of {res.frames_sent} frames answered, errors "
                      f"{[e for s in res.streams for e in s.errors][:3]}")
                cfg = manager._cfg_for(11 if name == CP_ENTRY else 6)
                check((cfg.velocity_cols is None) == (name != CP_ENTRY),
                      f"{name}: velocity_cols {cfg.velocity_cols}")
                lat = [x for s in res.streams for x in s.latencies_ms]
                served[name] = {**replay_matches_plain(recorder.frames, cfg, name),
                                "streams": streams, "frames": streams * frames,
                                "p50_ms": float(np.percentile(lat, 50)),
                                "p99_ms": float(np.percentile(lat, 99)),
                                "frames_per_s": res.frames_ok / res.wall_s}
                launches[kernel] = counts[kernel]
            stats = manager.stats()
            check(stats["inflight_frames"] == 0 and stats["ended_total"] == (
                SESSION_CP_STREAMS + SESSION_2D_STREAMS + 2), f"session stats {stats}")
            result["served"] = served

            # -- 4b. a CenterPoint request's p50 with and without a sequence_id
            inputs = cloud(0, 0)
            lat = {"stateless": [], "session": []}
            for r in range(2 * 30):
                kind = ("stateless", "session")[(r + r // 2) % 2]  # A B B A
                req = InferRequest(CP_ENTRY, inputs, sequence_id="p50" if kind == "session"
                                   else "")
                t0 = time.perf_counter()
                channel.do_inference(req)
                lat[kind].append(time.perf_counter() - t0)
            p50 = {k: 1e3 * float(np.median(v)) for k, v in lat.items()}
            result["centerpoint_p50_ms"] = {**p50, "added": p50["session"] - p50["stateless"]}
        finally:
            client.close()
            server.stop()

    # -- 3. the echo drive -------------------------------------------------------
    spec = ModelSpec(name="echo", version="1",
                     inputs=(TensorSpec("detections", (-1, 11), "FP32"),
                             TensorSpec("valid", (-1,), "BOOL")),
                     outputs=(TensorSpec("detections", (-1, 11), "FP32"),
                              TensorSpec("valid", (-1,), "BOOL")))
    repo = ModelRepository()
    repo.register(spec, lambda inputs: {"detections": inputs["detections"],
                                        "valid": inputs["valid"]})
    echo_channel = CUDAChannel(repo)
    echo = SessionManager(max_sessions=16, tracker=tracking.TrackerConfig(max_tracks=32))
    echo_channel.attach_sessions(echo)
    server = InferenceServer(repo, echo_channel, address="127.0.0.1:0", max_workers=16)
    server.start()
    try:
        # one warm stream: the tracker's graph for these shapes is captured
        # before the drive
        loadgen.run_streams(f"127.0.0.1:{server.port}", "echo", 1,
                            lambda i: loadgen.synthetic_stream(n_frames=2, seed=99),
                            stream_id_prefix="warm", realtime=False)
        before = echo.stats()
        client = GRPCChannel(f"127.0.0.1:{server.port}", timeout_s=60.0)
        recorder = _Recorder(client)
        try:
            res = loadgen.run_streams(
                recorder, "echo", SESSION_ECHO_STREAMS,
                lambda i: loadgen.synthetic_stream(n_frames=SESSION_ECHO_FRAMES,
                                                   fps=SESSION_ECHO_FPS, n_objects=4, seed=i),
                deadline_s=60.0)
        finally:
            client.close()
    finally:
        server.stop()
    summary, stats = res.summary(), echo.stats()
    check(res.goodput == 1.0 and res.aliases == 0 and res.id_switches == 0,
          f"echo drive {summary}")
    check(stats["frames_total"] - before["frames_total"] == SESSION_ECHO_STREAMS
          * SESSION_ECHO_FRAMES and stats["ended_total"] - before["ended_total"]
          == SESSION_ECHO_STREAMS and stats["active_sessions"] == 0,
          f"echo drive session stats {stats} (before it {before})")
    result["echo"] = {**summary, "sustained_fps": [s.sustained_fps for s in res.streams],
                      "track_births": stats["track_births_total"],
                      "vs_plain": replay_matches_plain(recorder.frames, echo.tracker, "echo")}
    emit("sessions", card, **result, launches=launches, tracker_s=t_tracker,
         wall_s=time.perf_counter() - t_phase)
    return launches


# phase 39: the front-door router over two serve replicas
ROUTER_LABEL = "smoke/fleet"
ROUTER_HEDGED = 24  # hedged yolov5_crop requests, each held bitwise to replica 0's answer
ROUTER_TIMED = 40  # yolov5_crop requests a leg, routed and direct in turns
ROUTER_STREAMS, ROUTER_STREAM_FRAMES = 2, 8  # CenterPoint streams at the 262,144 bucket
ROUTER_RATE_S, ROUTER_OPEN_S, ROUTER_KILL_S = 1.0, 3.0, 1.0
ROUTER_COMPLETE = 0.9  # the share of the open loop that must complete across the kill
# a replica: `serve`, and on SIGUSR1 a line of its kernels' launch counts
# (COUNTER_NAMES' order)
REPLICA_CHILD = (
    "import json, signal, sys\n"
    "from triton_client_tpu_torch.cli import serve\n"
    "from triton_client_tpu_torch.ops import (gpu_decode, gpu_decode3d, gpu_nms, gpu_segment,\n"
    "                                         gpu_suppress3d, gpu_voxel)\n"
    "counters = (gpu_decode.launches, gpu_nms.launches, gpu_decode3d.launches,\n"
    "            gpu_suppress3d.launches, gpu_voxel.launches, gpu_segment.launches,\n"
    "            gpu_decode3d.gathered_launches)\n"
    "signal.signal(signal.SIGUSR1, lambda *_: print('launches ' + json.dumps(\n"
    "    [c.count for c in counters]), flush=True))\n"
    "serve.main(sys.argv[2:])\n")


def replica_launches(replica, timeout_s: float = 30.0) -> dict:
    """A replica's kernel launch counts so far, by COUNTER_NAMES."""
    import signal

    proc, _, lines, _ = replica
    seen = len(lines)
    proc.send_signal(signal.SIGUSR1)
    t_end = time.perf_counter() + timeout_s
    while time.perf_counter() < t_end:
        for line in lines[seen:]:
            if line.startswith("launches "):
                return dict(zip(COUNTER_NAMES, json.loads(line.split(" ", 1)[1])))
        time.sleep(0.01)
    fail(f"replica {proc.pid} sent no launch counts: {lines[-5:]}")


def arrays_bitwise_equal(got: dict, want: dict) -> bool:
    """Two responses' outputs: the same names, dtypes, shapes and bytes."""
    return got.keys() == want.keys() and all(
        np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
        and np.asarray(got[k]).shape == np.asarray(want[k]).shape
        and np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes() for k in got)


def launches_between(before: list[dict], after: list[dict]) -> list[dict]:
    return [{k: a[k] - b[k] for k in COUNTER_NAMES if a[k] - b[k]} for b, a in zip(before, after)]


def route_tool(endpoints: list[str], models: list[str]) -> tuple[int, str]:
    """``python -m triton_client_tpu_torch route`` as a user runs it."""
    argv = [sys.executable, "-m", "triton_client_tpu_torch", "route", *endpoints,
            "--timeout", "10"]
    for m in models:
        argv += ["-m", m]
    out = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=120)
    return out.returncode, out.stdout + out.stderr


class dialed_routers:
    """While open, every FrontDoorRouter that utils/loadgen dials from a
    list of endpoints is kept, with each request's (start, end, ok, its
    attempts' (kind, endpoint)) and each stream's responses: what a list
    target's run hides."""

    def __enter__(self) -> list:
        import threading

        from triton_client_tpu_torch.runtime import router

        self._module, self._base, built = router, router.FrontDoorRouter, []

        class Kept(router.FrontDoorRouter):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                self.calls, self.frames, self._keep = [], {}, threading.Lock()
                self._attempts = threading.local()  # _route runs on the caller's thread
                built.append(self)

            def _launch(self, rep, request, done, kind, index=0, ctx=None):
                self._attempts.log.append((kind, rep.endpoint))
                return super()._launch(rep, request, done, kind, index, ctx)

            def do_inference(self, request):
                t0, ok, self._attempts.log = time.perf_counter(), False, []
                try:
                    resp = super().do_inference(request)
                    ok = True
                finally:
                    with self._keep:
                        self.calls.append((t0, time.perf_counter(), ok,
                                           tuple(self._attempts.log)))
                        if ok and request.sequence_id:
                            self.frames.setdefault(request.sequence_id, []).append(resp.outputs)
                return resp

        router.FrontDoorRouter = Kept
        return built

    def __exit__(self, *exc) -> None:
        self._module.FrontDoorRouter = self._base


def local_ids(outputs: dict) -> dict:
    """A session response's track ids without the replica namespace and the
    session epoch (ids below 1 kept), and the namespaces its ids carry."""
    out, spaces = {}, set()
    for key in ("det_track_ids", "track_ids"):
        ids = np.asarray(outputs[key]).astype(np.int64)
        spaces |= {int(v) >> 27 for v in ids[ids > 0].reshape(-1)}
        out[key] = np.where(ids > 0, ids & 0xFFFF, ids).tobytes()
    return {"ids": out, "namespaces": spaces}


def run_router(card: str) -> dict:
    """Phase 39: the front-door router (runtime/router.py) over two `serve`
    replicas on the card, each a process of its own over one repository
    (phase 38's: examples/centerpoint_nusc with seeded det3d weights and
    yolov5_crop at conf 0.05, full width) with --warmup --replica-of
    smoke/fleet and session id namespaces 1 and 2.

    a. `route` over both endpoints: both IN-ROTATION with the label, 2/2.
    b. 24 seeded 480x640 yolov5_crop frames through a FrontDoorRouter whose
       hedging is forced (4 samples, the 5% quantile, budget 1.0): every
       response bitwise equal to the same request sent by a GRPCChannel to
       replica 0, at least one hedge; kernel 1 launched on the replicas
       once an attempt that ran (24 to 24 + hedges), no other kernel. Then
       40 requests a leg through a router without hedges and directly to
       replica 0, in turns: the router's host cost in p50 and p99.
    c. run_streams over the list, 2 CenterPoint streams x 8 clouds at the
       262,144 bucket, realtime=False, the prefix chosen so the streams'
       rendezvous owners differ: 16 affinity-routed frames, no hedge or
       handoff, 8 kernel-4 launches on each replica and no other kernel;
       every response's detections bitwise and track ids equal (less the
       namespace and epoch bits) to the same drive against replica 0 alone,
       and its ids in its owner's namespace.
    d. run_open_loop over the list, yolov5_crop at half the frames/s of 4
       unary clients against replica 0 (phase 33's closed loop), for 3 s;
       replica 1 is SIGKILLed 1 s in. Every scheduled request completes or
       surfaces an error, at least 90% complete, failovers >= 1; `route`
       then prints 1/2 in rotation; one more frame of the stream replica 1
       owned, through a router that has not probed, re-homes: one handoff,
       its retry on replica 0 with the session restarted, its ids in
       namespace 1.
    Line router: the routed and direct p50/p99, the time from the kill to
    the first routed success, hedges launched and won, each router's
    stats(). Returns the kernels' launches in parts b and c."""
    import signal
    import tempfile
    import threading

    from triton_client_tpu_torch.channel.base import InferRequest
    from triton_client_tpu_torch.channel.grpc_channel import GRPCChannel
    from triton_client_tpu_torch.io.sources import SyntheticImageSource
    from triton_client_tpu_torch.obs.trace import Tracer
    from triton_client_tpu_torch.pipelines.detect3d import prepare_points
    from triton_client_tpu_torch.runtime.router import FrontDoorRouter, _rendezvous_score
    from triton_client_tpu_torch.utils import loadgen

    t_phase = time.perf_counter()
    result, launches = {}, {}
    models = ["yolov5_crop", CP_ENTRY]
    with tempfile.TemporaryDirectory(prefix="router_") as tmp:
        cwd = os.getcwd()
        os.chdir(ROOT)  # the entries name data/ files relative to the checkout
        try:
            root = sessions_repository(pathlib.Path(tmp))
        finally:
            os.chdir(cwd)
        flags = ("--warmup", "--replica-of", ROUTER_LABEL, "--max-workers", "8",
                 "--max-sessions", "16")
        spawned = [spawn_serve(root, (*flags, "--session-id-namespace", str(ns)),
                               command=("-c", REPLICA_CHILD)) for ns in (1, 2)]
        direct = None
        try:
            replicas = [wait_serve(sp, timeout_s=300.0) for sp in spawned]
            endpoints = [r[1] for r in replicas]
            result["serve_ready_s"] = time.perf_counter() - t_phase

            # -- a. the route tool ------------------------------------------------
            code, out = route_tool(endpoints, models)
            check(code == 0 and out.count("IN-ROTATION") == 2
                  and out.count(f"replica_of={ROUTER_LABEL}") == 2
                  and "-- 2/2 in rotation" in out, f"route over the fleet: rc {code}\n{out}")
            result["route_before"] = out.strip().splitlines()

            # -- b. hedged requests, bitwise against replica 0 ----------------------
            frames = [f.data[None] for f in SyntheticImageSource(ROUTER_HEDGED, FRAME_HW, seed=39)]
            direct = GRPCChannel(endpoints[0], timeout_s=120.0)
            want = [direct.do_inference(InferRequest("yolov5_crop", {"images": f})).outputs
                    for f in frames]
            # replica 1's first frame of this shape captures its graph: off the count
            warm = GRPCChannel(endpoints[1], timeout_s=120.0)
            try:
                warm.do_inference(InferRequest("yolov5_crop", {"images": frames[0]}))
            finally:
                warm.close()
            before = [replica_launches(r) for r in replicas]
            hedging = FrontDoorRouter(endpoints, models=models, timeout_s=120.0,
                                      hedge_min_samples=4, hedge_quantile=0.05,
                                      hedge_budget_fraction=1.0)
            try:
                got = [hedging.do_inference(InferRequest("yolov5_crop", {"images": f})).outputs
                       for f in frames]
                time.sleep(0.5)  # a cancelled loser still runs on its replica
                hedged = hedging.stats()
            finally:
                hedging.close()
            ran = launches_between(before, [replica_launches(r) for r in replicas])
            for k, (g, w) in enumerate(zip(got, want)):
                check(arrays_bitwise_equal(g, w), f"routed request {k} differs from replica 0's")
            n1 = sum(r.get("decode_nms_2d", 0) for r in ran)
            check(hedged["hedges_launched"] >= 1 and hedged["errors_total"] == 0,
                  f"hedging router stats {hedged}")
            check(ROUTER_HEDGED <= n1 <= ROUTER_HEDGED + hedged["hedges_launched"]
                  and all(set(r) <= {"decode_nms_2d"} for r in ran),
                  f"hedged leg launches {ran}, {hedged['hedges_launched']} hedges")
            launches["decode_nms_2d"] = n1
            result["hedged"] = {"requests": ROUTER_HEDGED, "bitwise": True,
                                "launches_by_replica": ran, "stats": hedged}

            plain = FrontDoorRouter(endpoints, models=models, timeout_s=120.0,
                                    hedge_min_samples=10**9)
            lat = {"routed": [], "direct": []}
            try:
                req = InferRequest("yolov5_crop", {"images": frames[0]})
                for r in range(2 * ROUTER_TIMED):
                    kind = ("routed", "direct")[(r + r // 2) % 2]  # A B B A
                    t0 = time.perf_counter()
                    (plain if kind == "routed" else direct).do_inference(req)
                    lat[kind].append(1e3 * (time.perf_counter() - t0))
                result["timed_stats"] = plain.stats()
            finally:
                plain.close()
            result["yolov5_crop_ms"] = {
                k: {"p50": float(np.percentile(v, 50)), "p99": float(np.percentile(v, 99))}
                for k, v in lat.items()}
            result["router_cost_p50_ms"] = (result["yolov5_crop_ms"]["routed"]["p50"]
                                            - result["yolov5_crop_ms"]["direct"]["p50"])

            # -- c. streams by affinity -----------------------------------------------
            def owner(sid: str) -> str:
                return max(endpoints, key=lambda e: (_rendezvous_score(sid, e), e))

            prefix = next(f"cp{k}" for k in range(256)
                          if owner(f"cp{k}-0") != owner(f"cp{k}-1"))
            cp_extra = direct.get_metadata(CP_ENTRY).extra

            def cloud(stream: int, k: int) -> dict:
                pc = uniform_clouds(3900 + stream, NUSC_RANGE, SESSION_CP_POINTS, 1)[0]
                pc[:, 0] += 0.2 * k
                padded, m = prepare_points(pc, 5, cp_extra["point_buckets"],
                                           cp_extra.get("z_offset", 0.0))
                return {"points": padded, "num_points": np.asarray(m, np.int32)}

            clouds = {i: [(0.0, cloud(i, k)) for k in range(ROUTER_STREAM_FRAMES + 1)]
                      for i in range(ROUTER_STREAMS)}

            def source(i):
                return clouds[i][:ROUTER_STREAM_FRAMES]

            # warm: each replica's tracker graph for these shapes, off the count
            for ep in endpoints:
                loadgen.run_streams(ep, CP_ENTRY, 1, lambda i: source(0)[:2],
                                    stream_id_prefix="warm", realtime=False, deadline_s=300.0)
            before = [replica_launches(r) for r in replicas]
            with dialed_routers() as built:
                res = loadgen.run_streams(endpoints, CP_ENTRY, ROUTER_STREAMS, source,
                                          deadline_s=300.0, stream_id_prefix=prefix,
                                          realtime=False)
            ran = launches_between(before, [replica_launches(r) for r in replicas])
            (streams_router,) = built
            streamed = streams_router.stats()
            n_frames = ROUTER_STREAMS * ROUTER_STREAM_FRAMES
            check(res.frames_ok == res.frames_sent == n_frames and res.goodput == 1.0,
                  f"routed streams: {res.frames_ok} of {res.frames_sent}, errors "
                  f"{[e for s in res.streams for e in s.errors][:3]}")
            check(streamed["affinity_routed"] == n_frames and streamed["hedges_launched"] == 0
                  and streamed["affinity_handoffs"] == 0 and streamed["failovers"] == 0,
                  f"streams router stats {streamed}")
            check(ran == [{"suppress_pack_3d": ROUTER_STREAM_FRAMES}] * 2,
                  f"stream launches by replica {ran}: each replica owns one stream")
            launches["suppress_pack_3d"] = n_frames
            solo = _Recorder(direct)
            loadgen.run_streams(solo, CP_ENTRY, ROUTER_STREAMS, source, deadline_s=300.0,
                                stream_id_prefix=prefix, realtime=False)
            ids_seen = 0
            for sid, outs in streams_router.frames.items():
                ns = endpoints.index(owner(sid)) + 1
                check(len(outs) == len(solo.frames[sid]) == ROUTER_STREAM_FRAMES,
                      f"{sid}: {len(outs)} routed frames")
                for k, (o, w) in enumerate(zip(outs, solo.frames[sid])):
                    check(arrays_bitwise_equal({"d": o["detections"]}, {"d": w["detections"]}),
                          f"{sid} frame {k} detections")
                    got_ids, want_ids = local_ids(o), local_ids(w)
                    check(got_ids["ids"] == want_ids["ids"], f"{sid} frame {k}: track ids")
                    check(got_ids["namespaces"] <= {ns} and want_ids["namespaces"] <= {1},
                          f"{sid} frame {k}: namespaces {got_ids['namespaces']}, owner {ns}")
                    ids_seen += int((np.asarray(o["track_ids"]) > 0).sum())
            result["streams"] = {"frames": n_frames, "owners": {s: owner(s) for s in
                                                               streams_router.frames},
                                 "launches_by_replica": ran, "positive_track_ids": ids_seen,
                                 "p50_ms": float(np.percentile(
                                     [x for s in res.streams for x in s.latencies_ms], 50)),
                                 "stats": streamed}

            # -- d. failover: replica 1 killed under an open loop ---------------------
            pool = loadgen.run_pool(endpoints[0], "yolov5_crop", {"images": frames[0]}, 4,
                                    ROUTER_RATE_S, deadline_s=120.0, stagger_s=0.1,
                                    mode="unary")
            check(not pool.errors and pool.served_frames > 0, f"closed loop: {pool.errors[:3]}")
            rate = pool.fps / 2
            killed = {}

            def kill():
                time.sleep(ROUTER_KILL_S)
                killed["t"] = time.perf_counter()
                replicas[1][0].send_signal(signal.SIGKILL)

            # this process's own view of the card across the kill: one tiny op
            # and a sync at a time; a long gap is the card, not the router
            probe_stop, gaps = threading.Event(), []

            def probe_card():
                x = torch.zeros(1, device="cuda")
                last = time.perf_counter()
                while not probe_stop.is_set():
                    x += 1
                    torch.cuda.synchronize()
                    now = time.perf_counter()
                    gaps.append((now, now - last))
                    last = now
                    time.sleep(0.001)

            killer = threading.Thread(target=kill)
            prober = threading.Thread(target=probe_card)
            with dialed_routers() as built:
                prober.start()
                killer.start()
                try:
                    res = loadgen.run_open_loop(endpoints,
                                                [("yolov5_crop", {"images": frames[0]})],
                                                rate_qps=rate, duration_s=ROUTER_OPEN_S, seed=39,
                                                deadline_s=60.0, warm=False)
                finally:
                    killer.join()
                    probe_stop.set()
                    prober.join()
            (open_router,) = built
            opened = open_router.stats()
            replicas[1][0].wait(timeout=30)
            check(res.completed + len(res.errors) == res.scheduled,
                  f"open loop lost requests: {res.completed} + {len(res.errors)} of "
                  f"{res.scheduled}")
            check(res.completed >= ROUTER_COMPLETE * res.scheduled,
                  f"open loop across the kill: {res.completed} of {res.scheduled}, errors "
                  f"{res.errors[:3]}")
            check(opened["failovers"] >= 1, f"no failover across the kill: {opened}")
            after_kill = [(t1 - killed["t"], t1 - t0) for t0, t1, ok, _ in open_router.calls
                          if ok and t0 >= killed["t"]]
            check(bool(after_kill), "no routed success after the kill")
            # the slowest requests of the window: when they started against
            # the kill, and the attempts each took
            slowest = [{"start_after_kill_ms": 1e3 * (t0 - killed["t"]),
                        "ms": 1e3 * (t1 - t0), "ok": ok,
                        "attempts": [f"{kind}@{endpoints.index(ep)}" for kind, ep in atts]}
                       for t0, t1, ok, atts in sorted(open_router.calls,
                                                       key=lambda c: c[0] - c[1])[:8]]
            code, out = route_tool(endpoints, models)
            check(code == 0 and "-- 1/2 in rotation" in out and "DEAD" in out,
                  f"route after the kill: rc {code}\n{out}")
            result["route_after"] = out.strip().splitlines()

            moved = next(s for s in streams_router.frames if owner(s) == endpoints[1])
            tracer = Tracer(capacity=4)
            rehome = FrontDoorRouter(endpoints, probe_interval_s=0.0, timeout_s=120.0,
                                     tracer=tracer)
            try:
                before0 = replica_launches(replicas[0])
                resp = rehome.do_inference(InferRequest(
                    CP_ENTRY, clouds[int(moved.rsplit("-", 1)[1])][ROUTER_STREAM_FRAMES][1],
                    sequence_id=moved))
                handed = rehome.stats()
            finally:
                rehome.close()
            ran0 = launches_between([before0], [replica_launches(replicas[0])])[0]
            (trace,) = tracer.recent()
            atts = sorted((sp.attrs for sp in trace.spans if sp.name == "attempt"),
                          key=lambda a: a["attempt"])
            check(handed["affinity_handoffs"] == 1 and handed["failovers"] == 1,
                  f"re-homing router stats {handed}")
            check([(a["kind"], a["endpoint"], a.get("error")) for a in atts]
                  == [("primary", endpoints[1], "UNAVAILABLE"), ("retry", endpoints[0], None)],
                  f"re-homed frame's attempts {atts}")
            check(local_ids(resp.outputs)["namespaces"] <= {1}, "re-homed ids not namespace 1")
            check(ran0 == {"suppress_pack_3d": 1}, f"re-homed frame's launches {ran0}")
            result["failover"] = {
                "offered_qps": rate, "closed_loop_frames_per_s": pool.fps,
                "scheduled": res.scheduled, "completed": res.completed,
                "errors": len(res.errors), "p50_ms": res.percentile(50),
                "p99_ms": res.percentile(99),
                "kill_to_first_success_ms": 1e3 * min(t for t, _ in after_kill),
                "worst_after_kill_ms": 1e3 * max(lat for _, lat in after_kill),
                "slowest": slowest,
                "card_gap_ms": {
                    "before_kill": 1e3 * max((g for t, g in gaps if t < killed["t"]), default=0.0),
                    "after_kill": 1e3 * max((g for t, g in gaps if t >= killed["t"]),
                                            default=0.0)},
                "stats": opened, "rehomed_stream": moved, "rehome_stats": handed,
                "rehome_positive_track_ids": int((np.asarray(resp.outputs["track_ids"])
                                                  > 0).sum())}
        finally:
            if direct is not None:
                direct.close()
            codes = [stop_serve(proc, reader) for proc, _, reader, _ in spawned]
    check(codes[0] == 0, f"replica 0 exited {codes[0]}")
    emit("router", card, **result, launches=launches, wall_s=time.perf_counter() - t_phase)
    return launches

if __name__ == "__main__":
    sys.exit(main())
