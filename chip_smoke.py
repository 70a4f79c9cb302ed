#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (seaweedfs_tpu_torch).

    python3 chip_smoke.py [--volume-mb 1024] [--bits-volume-mb 64]
                          [--sched-volume-mb 256] [--sched-volumes 8]
                          [--baseline DIR] [--only gf_xor|gf_bits|gf_sel]

Needs one CUDA card, the CUDA toolkit (nvcc) and nvidia-smi; exits non-zero
and prints no result without them. Phases, each printing its own line:

  1. device          card name, and name + power limit from nvidia-smi
  2. build           nvcc builds K1 and K2 from ops/csrc/ and K3 (the
                     gf_sel.cu template) once per encode matrix it serves
                     here, all in parallel, with each build's time and
                     registers (K1 by C/R, K2 by k-steps S)
  3. kernels         K1 (gf_xor.cu), K2 (gf_bits.cu) and K3 (gf_sel.cu)
                     against their plain PyTorch versions on the card, byte
                     for byte: K1 and K2 at the encode [4,10] and a fused
                     [3,10] decode matrix (plus a wide [8,40] matrix), K3 at
                     the encode matrices of RS(10,4), RS(6,3), RS(12,4) and
                     lrc_10_2_2, each over B in {1 MiB, 1 MiB + 4, 4095, 1},
                     K1 and K3 also at a stacked flush's width (6 MiB +
                     4093: several slabs and a ragged tail side by side,
                     row stride not a multiple of 16, as the scheduler
                     packs them), a row-strided input, the refusal of a
                     transposed one,
                     and the golden RS(10,4) shard hashes; K2 first at the
                     GF identity [10,10] and its [1,10] rows (its MMA
                     fragment layout) and at the stacked width too. Then
                     the layouts the kernels realign: column slices at
                     each row offset 0-15 of a buffer with row stride
                     8221, slices whose span ends at the buffer's last
                     byte, widths 1-47, K1 and K2 at every R in 1-8 and 14,
                     K2 at C in {1, 3, 17, 33, 64}. Then CUDA-event times of
                     each kernel and plain version at the shapes the main
                     path launches (TIMED_SHAPES), each beside its bytes
                     bound, and an empty kernel's time at the degraded-read
                     shape (its floor); with --baseline, another
                     checkout's K1, K2 and K3 timed in the same turns.
                     Every library must build without register spills
  4. pipeline        a seeded 1 GiB volume (.dat + .idx) through the port's
                     write_ec_files / write_sorted_file_from_idx with
                     new_coder() on cuda (kernel K1, the default): shard
                     sha256s against the port's numpy cpu coder, rebuild of
                     shards {0, 5, 13}, degraded reads with shard 3 gone
  5. pipeline-bits   encode + rebuild of a smaller volume with kernel K2
                     selected (SEAWEEDFS_TORCH_KERNEL=bits), against the
                     cpu coder
  6. pipeline-sched  8 seeded volumes encoding at once through one coder
                     with SEAWEEDFS_TORCH_KERNEL=sel: their slabs share the
                     dispatch scheduler's encode lane, one K3 launch per
                     flush; then all 8 rebuild shards {0, 5, 13} at once
                     and 8 readers read with shard 3 gone (K1, on the
                     reconstruct lanes). Shards against the cpu coder;
                     K3 launches must equal the encode lane's batches, and
                     some batch must have stacked more than one slab
  7. mesh            the multi-GPU coder (parallel/mesh.ShardedCoder) over
                     the one card listed twice, [cuda:0, cuda:0]: entry()
                     (K2) and dryrun_multichip(2); the column split of
                     RS(10,4) at [10, 1 MiB + 4093], reconstruct_stacked
                     and the V-axis split with shards {0, 5, 13} lost, the
                     parity probe (0 clean, the flipped byte's value
                     after one flip), with K1 ("xor") and then K2
                     ("bits"), each against the single-device
                     RSCodecTorch, the plain version and the numpy coder;
                     4 seeded volumes of 64 MiB encoding at once through
                     the scheduler's per-chip lanes (encode slabs and
                     batches on chip 0 and chip 1, reason chip_affine),
                     shards against the numpy coder, their 3-shard
                     rebuild at once (some batch through the V split,
                     sha-identical); an lrc_10_2_2 volume encoded and
                     rebuilt and a pm_mbr_6_3_5 stripe encoded and one
                     node repaired on the mesh, against the numpy coder;
                     RSCodecNative and the XOR schedule (g++ build of
                     this machine) at [4,10] x 1 MiB against rs_cpu. The
                     current CUDA device must be the same after every
                     launch on another entry. Two entries of one card
                     share its SMs: no multi-GPU speed is measured
  8. store           the volume server's storage layer: a Store over a
                     fresh directory with its default coder (new_coder():
                     cuda, K1, the dispatch scheduler) takes seeded needles
                     of 1-64 KiB through Store.write_needle until the .dat
                     reaches 512 MiB; then the ec.encode handlers' sequence
                     (mark read-only, write_ec_files through
                     Store.coder_for, write_sorted_file_from_idx,
                     save_volume_info, mount_ec_shards, delete_volume),
                     3 shards {0, 5, 13} deleted and the shards remounted,
                     every needle read through Store.find_ec_volume and
                     Needle.from_bytes (CRC checked), rebuild_ec_files +
                     rebuild_ecx_file and a remount, then close() and a
                     new Store on the same directory (the restart) that
                     must find the EC volume and read a sample back. Shard
                     sha256s against the numpy cpu coder, rebuilt shards
                     sha-identical, reads byte-exact, the dirty marker
                     lifted by close()
  9. server          the volume server as a process: `python3 -m
                     seaweedfs_tpu_torch volume` with its default coder
                     (cuda, K1) and an unreachable master; over gRPC
                     AllocateVolume, 256 MiB of seeded 1-64 KiB needles
                     POSTed over HTTP by 8 clients, an eighth of them
                     GET from the plain volume, VolumeMarkReadonly,
                     VolumeEcShardsGenerate, VolumeUnmount and
                     VolumeEcShardsMount; shards {0, 5, 13} unmounted,
                     deleted and the rest remounted, every needle GET by 8
                     readers (live and degraded timed apart);
                     VolumeEcShardsRebuild; one byte of .ec03 flipped on
                     disk, found and repaired by VolumeScrub (full,
                     repair), a second pass clean, every needle GET again;
                     SIGTERM. Shard sha256s against the numpy cpu coder,
                     rebuilt and repaired shards sha-identical, GETs
                     byte-exact, exit 0 with the dirty marker lifted; the
                     server's /status (dispatch lanes) and /metrics (K1
                     launches by R) show each step's EC work ran K1 on the
                     card
 10. cluster         the operator's path through a cluster of processes:
                     three `python3 -m seaweedfs_tpu_torch master -peers
                     ... -mdir ...` (one Raft group; -volumeSizeLimitMB
                     1024, -defaultReplication 001) and four `volume`
                     servers with their default coder (cuda, K1) in racks
                     r0, r0, r1, r1, given all three masters, all started
                     at once.
                     `shell` volume.grow of one volume of collection c1
                     with replication 001; 8 clients write seeded 1-64 KiB
                     needles through operation.submit until it holds 128
                     MiB of needle bytes (both replicas hold every one); a
                     seeded 10% deleted through the primary, then
                     `volume.vacuum -garbageThreshold 0.05` (both replicas
                     compact and commit; every needle read back from each,
                     byte-exact or 404); on the live volume `backup` in
                     full, a JSON, a gzipped CSV and a PNG needle written
                     into it, the PNG GET with ?width= through the C++
                     plane's 307 to Python (resized as images.resized
                     does, or the stored bytes where the host has no
                     PIL), the master's and the server's /ui naming the
                     fleet's servers and the volume, `backup` again
                     (incremental: the needles the server holds), then
                     `compact` and `export` of the backup (every live
                     needle a file), each a process of the port;
                     `lock; ec.encode; unlock`, the
                     default streamed path (placement first, then K1 at
                     R = 4 on the source while it streams each
                     destination's shards to it, rack-aware 4/4/3/3, both
                     replicas deleted; no destination resumed or fell
                     back to the copy; 14 shard sha256s wherever they
                     landed against the numpy cpu coder; each
                     destination's .dig manifest against its files; the
                     source's stream counters; every server's CRC-32C
                     compiled; volume.list shows the EC volume on all
                     four servers); SIGKILL of the Raft leader: the
                     seconds until `cluster.raft.ps` names a new leader
                     and an assign succeeds, whose new volume's id is
                     above every id before the loss (MaxVolumeId is
                     replicated), everything below through the new
                     leader; SIGKILL of a
                     server holding 4 shards and 8 readers GET every
                     surviving needle through MasterClient lookups
                     (degraded reads gather survivors from the other
                     servers over VolumeEcShardRead); the Query RPC over
                     the JSON and the gzipped CSV needle on a surviving
                     shard holder equal to what json and csv give for the
                     same filter; a fresh empty server
                     and `ec.rebuild` (sha-identical); a byte flipped in a
                     shard on disk found and repaired by `volume.scrub
                     -full`, a second pass clean; the killed master
                     started again on its -mdir rejoins as a follower,
                     `cluster.raft.remove` and `cluster.raft.add` of it;
                     config #4: four volumes
                     of 32 MiB in collection c4 streamed at once by
                     `ec.encode -collection c4 -fullPercent 2` while the
                     fresh server (its SWFS_FAILPOINTS) drops one incoming
                     stream once a third into a shard: exactly one resume,
                     fewer bytes than its share, shards against the numpy
                     cpu coder, every needle GET through lookups;
                     `ec.decode` and every needle GET again; a second
                     collection of 128 MiB (`fix` of a copy of it without
                     its .idx gives the .idx back byte for byte) encoded
                     by the copy path
                     (`-stream 0`) with `-dataShards 6 -parityShards 3`
                     (BASELINE config #5), a server lost, every needle GET
                     byte-exact; SIGTERM to every process: exit 0, no
                     dirty marker. Each step's wall and rate, K1's
                     launches by R summed from every server's /metrics,
                     and the host's NUMA layout
 11. filer           the filer as an operator runs it, as processes: a
                     `master` (-volumeSizeLimitMB 256), four `volume`
                     servers with their default coder (cuda, K1) in racks
                     r0, r0, r1, r1 and a `filer` (-store sqlite, the
                     default -maxMB 4, its own -dir, its chunk cache off
                     so that every GET reaches the volume servers).
                     8 clients PUT about 0.6 GB of seeded files through its
                     HTTP API: 250 of 1-64 KiB (150 in one directory,
                     the rest in 64 nested ones) and 16 of 8-64 MiB (2-16
                     chunks each); every file GET byte-exact with its md5
                     ETag, range GETs across a chunk boundary, the
                     150-entry directory listed in pages (limit,
                     lastFileName), one rename (gRPC AtomicRenameEntry),
                     one recursive DELETE, the directory's HTML page
                     (`?ui`) naming every file. Tiering: a fifth volume
                     server (-max 2) whose -tierConfig names an `s3`
                     backend at the fleet's S3 gateway (bucket tier,
                     signed with the S3 step's identity) takes 32 MiB of
                     seeded 1-64 KiB needles into volume 900 of
                     collection tier; `volume.tier.upload` moves its
                     .dat (sha256 taken first) into the bucket through
                     the gateway and the filer, the C++ plane lets go of
                     the volume, every needle reads back byte-exact from
                     the remote .dat. `lock; ec.encode -collection fc
                     -fullPercent 0.001; unlock` (streamed): every volume
                     holding chunks, 14 shard sha256s each against the
                     numpy cpu coder, K1 at R = 4 on every source. SIGKILL
                     of a server holding 4 shards; every surviving file
                     GET byte-exact by 8 readers, those with a chunk on a
                     lost shard timed apart, K1 at R = 4 on the
                     survivors; every tiered needle read again through
                     the erasure-coded bucket (K1 at R = 4 in those
                     reads), `volume.tier.download`, the .dat back with
                     its sha256, every needle read once more (that server
                     is never the one killed); `shell -filer` fs.ls,
                     fs.du, fs.cat and
                     fs.verify against the written set. The filer SIGTERMed
                     (exit 0) and started again on its -dir: a seeded
                     sample listed and read back. SIGTERM to every
                     process: exit 0, no dirty marker. Write GB/s and
                     files/s, live and degraded GET ms, the encode's
                     shell wall, the restart seconds, K1 by R.
                     The S3 gateway in the same fleet: `python3 -m
                     seaweedfs_tpu_torch s3 -filer <the filer>` started
                     with it. `shell -filer` s3.configure (an identity
                     with Read,Write,List,Tagging,Admin) and
                     s3.bucket.create, the identity pushed to the gateway
                     through SeaweedS3.Configure; an unsigned PUT refused
                     403. Every request below SigV4-signed (the port's
                     sigv4_client): 8 clients PUT 120 seeded objects of
                     1-64 KiB over 16 prefixes and 4 of 24-48 MiB in 8 MiB
                     multipart parts (about 0.2 GiB, into the filer's
                     collection, so the encode above covers them); a
                     paged ListObjectsV2 with a delimiter lists every key;
                     a CopyObject and an UploadPartCopy each equal their
                     source; `benchmark -n 2000 -size 4096 -c 8
                     -collection bench` with 0 failed. After the encode
                     and the SIGKILL, every object GET through the
                     gateway byte-exact with its ETag (the md5, or the
                     filer's chunk ETag of a multipart object), those
                     with a chunk on a lost shard timed apart, one Range
                     GET across a part boundary, K1 at R = 4 in those
                     reads; the `s3` process exits 0 on SIGTERM without
                     jax in sys.modules. PUT GB/s and objects/s, GET ms,
                     K1 by R, the benchmark's req/s.
                     The other gateways in the same fleet, started with
                     it: `webdav`, `ftp` (passive ports from a free
                     block), `iam` and `mq.broker` processes over the
                     filer, and the mount: a `mount -collection fc
                     -memoryLimitMB 16` process where the machine has
                     /dev/fuse and libfuse.so.2, else (the line says what
                     it lacks) the same WFS operations in this process
                     through the path operations the FUSE callbacks make
                     (mount.PathOps), with its control socket. Before the
                     encode: through the mount 25 files of 1-64 KiB in 6
                     directories and one of 24 MiB, a rename, a symlink,
                     a hard link and a user xattr, and `mount.configure
                     -quotaMB=1` through `shell -filer` (a write past it
                     ENOSPC), lifted again; through WebDAV 25 files by 8
                     clients and a 24 MiB chunked PUT, PROPFIND of each
                     directory, MKCOL, MOVE, COPY, a LOCK that refuses a
                     PUT without its token, UNLOCK; through FTP 30 files
                     and one of 16 MiB in passive mode, LIST; IAM
                     (SigV4-signed by the S3 step's Admin identity)
                     CreateUser, CreateAccessKey, PutUserPolicy,
                     ListUsers, the identity pushed to the S3 gateway: a
                     PUT and a GET with the new key, a PUT with it 403
                     once deleted; MQ: 1,000 records of 100-1,000 B on
                     one topic of 4 partitions, half through the broker's
                     gRPC Publish, half through its HTTP API, a
                     subscription of each partition from offset 0 in
                     order, the broker SIGINTed (its flush to the filer),
                     `mq.topic.list`, a new broker returning the same
                     records (MQ segments are inline filer entries: no
                     volume server holds them). After the SIGKILL every
                     gateway file read back byte for byte through a new
                     mount (cold cache), WebDAV (GET, a Range GET) and FTP
                     (RETR), those with a chunk on a lost shard timed
                     apart, K1 at R = 4 in those reads; every gateway
                     process exits 0 on SIGINT or SIGTERM without jax in
                     sys.modules.
                     The filer's tools in the same fleet: a second
                     filer, B (-collection fc, its own sqlite store),
                     started from a directory whose notification.toml
                     enables kafka at a FakeKafkaBroker in this process
                     (tests/fake_kafka.py, loaded by its path);
                     `filer.sync -a A -b B -a.path /sync
                     -isActiveActive`, `filer.replicate -sink local`,
                     `filer.meta.tail -pathPrefix /sync` and
                     `filer.meta.backup` as processes, following A
                     before the writes. Before the encode: 150 files of
                     1-64 KiB and one of 24 MiB PUT to A's /sync by 8
                     clients, filer.meta.backup SIGTERMed and started
                     again, 20 files to B's /sync, a rename across
                     directories and a delete on A; both filers and the
                     local sink converge on the same tree, every file
                     byte-exact on both, each path made once on each
                     filer (no event looped); `filer.copy` of a local
                     directory of 50 files and `filer.cat` of the 24 MiB
                     file byte-exact; a local directory of 100 files of
                     1-64 KiB and one of 24 MiB as remote storage
                     (`shell -filer` remote.configure, remote.mount, 20
                     files read through the filer, remote.cache of
                     every file, remote.uncache of 10, 5 changed on the
                     remote and `filer.remote.sync -dir /remote`, their
                     new bytes read back); the broker holds exactly B's
                     events, then one message per entry of B's /sync
                     from `fs.meta.notify /sync` run in B's directory.
                     After the SIGKILL: `filer.backup` of A's /sync and
                     /remote byte-exact (uncached files as the remote
                     holds them), B's /sync through B and the cached
                     /remote files through A by 8 readers, those with a
                     chunk on a lost shard timed apart, K1 at R = 4 in
                     those reads; filer.meta.backup's records each of
                     A's events once across its restart, filer.meta.tail
                     every /sync event since it started; every tool
                     process and filer B exit 0 on SIGTERM without jax.
                     A network metadata store in the same fleet: a third
                     filer (-collection fc) started from a directory whose
                     filer.toml enables [postgres2] at a
                     FakePostgresServer in this process (SCRAM auth;
                     tests/fake_postgres.py, loaded by its path), so its
                     namespace lives in Postgres over the wire protocol
                     and each S3 bucket in a table of its own. Before the
                     encode: 200 files of 1-64 KiB by 8 clients, 150 in
                     one directory and 50 in two buckets under
                     /buckets/, and one of 24 MiB. After the SIGKILL:
                     every file GET byte-exact with its md5 ETag, those
                     with a chunk on a lost shard timed apart, K1 at R = 4
                     in those reads; the wide directory listed in pages of
                     100; one bucket deleted (its table dropped in the
                     fake); the filer SIGTERMed (exit 0) and started again
                     on the same server, a sample listed and read back;
                     both processes without jax in sys.modules
 12. hot             the filer hot plane as `server -filer` runs it: one
                     `python3 -m seaweedfs_tpu_torch server -filer`
                     process (master, a volume server on its C++ data
                     plane, a filer whose C++ hot plane serves whole
                     objects under /buckets/ off that plane) with its
                     default coder (cuda, K1). 8 clients PUT 1,000 seeded
                     files of 1-64 KiB under /buckets/hot/ through the
                     filer's public port and 2 of 8 MiB (past the plane's
                     4 MiB max_body: 307ed to Python, chunked); every
                     file GET byte-exact (hot-plane answers and 307s
                     timed apart), the listings hold every file, a
                     DELETE through Python then a 404; `benchmark -filer`
                     and `benchmark -nativeClient` (-n 2000 -size 4096 -c
                     8) with 0 failed; the process SIGKILLed during a PUT
                     storm of 8 clients and started again on its
                     directory (the hot log replayed): every acknowledged
                     PUT reads back; `lock; ec.encode -volumeId <each
                     volume written>; unlock` (K1 at R = 4) and every
                     file read back through the filer again (the hot map
                     must not serve the removed plain volumes); SIGTERM:
                     exit 0 without jax in sys.modules

Every volume server these phases start (server, cluster, filer, hot) runs
the reference's default `-nativeDataPlane auto`: the C++ data plane on its
public port wherever g++ builds it. Each must report NativeDataPlane true
and NativeRequests > 0 in /status, and where it served GETs of 4,096 B
or more of needles the plane wrote (server, filer, hot) NativeSendfile >
0 (cluster's master replicates at 001, whose writes go through Python,
which tags each needle with the replica epoch, and the plane serves
tagged needles buffered, so cluster's read 0); a plane that did not
build fails the run. The
script's HTTP clients follow one 307 to its Location, as a client does,
and count them (REDIRECTS).

--only KERNEL builds, checks and times that kernel alone and runs only its
pipeline phases (a short loop for one kernel; K1's are pipeline, store,
server, cluster, filer and hot; the mesh phase needs K1 and K2, so it runs only
without --only); the run says what it skipped.

Each kernel's launch count is set to 0 just before each pipeline phase and
read just after; a kernel that path never launched fails the run. The
server phase's counts start at 0 with its process and are read from its
/metrics before and after each step. K1's count in the JSON line is the sum
over its seven phases (pipeline, mesh, store, server, cluster, filer, hot), K2's
over pipeline-bits and mesh. K1's launches are also split by R (1 or 2: a
degraded read through EcVolume, 4: a degraded GET through the server, 3:
rebuild, 4: encode). The
last lines are one JSON object of kernel numbers, the nvidia-smi line, and
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import argparse
import collections
import errno
import hashlib
import http.client
import json
import mmap
import os
import re
import shutil
import signal
import socket
import stat
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse

import numpy as np
import torch

from seaweedfs_tpu_torch.models import geometry
from seaweedfs_tpu_torch.models.coder import new_coder
from seaweedfs_tpu_torch.ops import _build, dispatch, gf256, gfmat, rs_bits, \
    rs_sel, rs_xor
from seaweedfs_tpu_torch.ops.rs_torch import RSCodecTorch
from seaweedfs_tpu_torch.pb import ec_geometry_pb2, rpc, scrub_pb2
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs
from seaweedfs_tpu_torch.scrub import digest
from seaweedfs_tpu_torch.storage import crc, ec_files, idx, recovery, types
from seaweedfs_tpu_torch.storage.ec_locate import Geometry, locate_data
from seaweedfs_tpu_torch.storage.ec_volume import (EcVolume, rebuild_ecx_file,
                                                   save_volume_info)
from seaweedfs_tpu_torch.storage.file_id import format_needle_id_cookie
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.utils import numa
from seaweedfs_tpu_torch.utils import stats as ec_stats

# sha256 of each shard row of RS(10,4) over rng(0xEC) [10, 4096] — the
# port's copy of tests/test_golden_identity.py GOLDEN_SHARD_SHA256
GOLDEN_SHARD_SHA256 = [
    "9c7355adf15e9cbec105e1dfbf16624080ca5e58ad6f4e2418ab703bc0c3f509",
    "71a8ffbe270988fb15d6e46614c29559185f003f5c70e7fab8190780dbea2377",
    "99f63810daa37174f8296cf932cd35196bcae55584966f9b98e92161a663bf98",
    "9011e6aeac31b87a2aea2bae59e3e5942caa18583d50be53d50b226fe44ab83a",
    "e3beb7ebaad84c1592916124d4199996fab784900ef63958375a6a32cd11ff48",
    "484de4f3ef9736d472a53931e89423e7daf5f210b7c2a3a6aa10fe86a89edeca",
    "2c420ae77040ba1734d37b9095a02517b2b2aaa3d4de477168f66d8169c2de0d",
    "714238432f92d7985b3226f5c9df7099c390b675d5e18d2ec5bb5aa69afc4919",
    "97aac53066ca8d0f942b03aa906a6f0030aca47cdf9f20cec7e0b65fec7c268a",
    "a6c91ad42931acaf2d0c39193070e41938fe6c210b32b4fe4d09db05e26eeb38",
    "5b84659c44c7daa6c956ec16ee7f5d8155913df1ddd33265f2ab82ee42783205",
    "89482c87207f8950afded88c6147b0619e15967a354d998a38890ebbcc4c5bc3",
    "09f935bbea5adeee0dd7dc305b2d95e25c2cb269ebaaff01d66b2c689cbb7966",
    "6fbd770c854d81a89eef262f06b512e0eb93f9febdb26f7267f80710114996a9",
]

MIB = 1 << 20
# the width of a stacked flush of the scheduler's lanes: six 1 MiB slabs
# and a ragged tail, packed side by side, so the row stride is no
# multiple of 16 and most chunks take the kernels' masked loads
STACKED_WIDTH = 6 * MIB + 4093
REBUILD_LOST = (0, 5, 13)
DEGRADED_SHARD = 3
# a degraded read's width: one interval of padded needle records, an
# 8-byte multiple that is no 16-byte one
DEGRADED_WIDTH = 24_584
# the server's degraded GET: one block of its reconstructed-interval cache
# (256 KiB), from its 10 planned survivors, solving
# every row outside them (lost 0, 5 and 13, and unread 12)
GET_WIDTH = dispatch.DEFAULT_CACHE_BLOCK
GET_UNREAD = (0, 5, 12, 13)
# the mesh phase's column-split width: 1 MiB and a ragged tail, no
# multiple of 8 * 2; also the width of its pm_mbr_6_3_5 stripe
MESH_WIDTH = MIB + 4093
PM_FAILED = 1  # the pm_mbr_6_3_5 node the mesh phase repairs
# (kernel, shape, matrix, B): the shapes the main path launches, timed
TIMED_SHAPES = (
    ("gf_xor", "encode [4,10]", "encode", MIB),
    ("gf_xor", "rebuild [3,10]", "decode", MIB),
    ("gf_xor", "degraded read [1,10]", "degraded", DEGRADED_WIDTH),
    ("gf_xor", "degraded GET [4,10]", "degraded GET", GET_WIDTH),
    ("gf_xor", "degraded read [2,10]", "degraded store", DEGRADED_WIDTH),
    ("gf_xor", "RS(6,3) encode [3,6]", "encode 6+3", MIB),
    ("gf_xor", "pm_mbr encode [30,12]", "pm_mbr encode", MESH_WIDTH),
    ("gf_xor", "pm_mbr repair [5,5]", "pm_mbr repair", MESH_WIDTH),
    ("gf_bits", "encode [4,10]", "encode", MIB),
    ("gf_bits", "rebuild [3,10]", "decode", MIB),
    ("gf_bits", "stacked flush [4,10]", "encode", STACKED_WIDTH),
    ("gf_bits", "degraded read [1,10]", "degraded", DEGRADED_WIDTH),
    ("gf_sel", "encode [4,10]", "encode", MIB),
    ("gf_sel", "stacked flush [4,10]", "encode", STACKED_WIDTH),
)
MIN_READS = 2000
MIN_HEALTHY_READS = 500

# memory rate by card (NVIDIA data sheets), for the bytes bound
_MEMORY_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                ("H200", 4.8e12), ("H100", 3.35e12))

# the pipeline phases that drive each kernel
PHASES = {"gf_xor": "pipeline, store, server, cluster, filer and hot",
          "gf_bits": "pipeline-bits",
          "gf_sel": "pipeline-sched"}
# each kernel: its module, operand form and the TPU kernel it replaces
KERNELS = {
    "gf_xor": dict(
        module=rs_xor, form="xor", source="seaweedfs_tpu_torch/ops/csrc/gf_xor.cu",
        replaces="seaweedfs_tpu/ops/rs_xor.py:115"),
    "gf_bits": dict(
        module=rs_bits, form="bits",
        source="seaweedfs_tpu_torch/ops/csrc/gf_bits.cu",
        replaces="seaweedfs_tpu/ops/rs_pallas.py:33"),
    "gf_sel": dict(
        module=rs_sel, form="sel",
        source="seaweedfs_tpu_torch/ops/csrc/gf_sel.cu",
        replaces="seaweedfs_tpu/ops/rs_xor.py:247"),
}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def memory_rate(name: str) -> float:
    for key, rate in _MEMORY_RATE:
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate on file for card {name!r}")


# -- kernels ------------------------------------------------------------------


def sel_matrices() -> dict[str, np.ndarray]:
    """The encode matrices K3 is built for and checked at: RS(10,4) (the
    default), RS(6,3) and RS(12,4) (BASELINE config #5), lrc_10_2_2."""
    return {name: geometry.get(name).parity_matrix()
            for name in ("rs_10_4", "rs_6_3", "rs_12_4", "lrc_10_2_2")}


def _operand(kind: str, matrix: np.ndarray, dev):
    """The kernel's operand: K3 takes the matrix itself (it is baked into
    the kernel), K1 and K2 derived forms on the card."""
    if kind == "sel":
        return matrix
    host = gfmat.xor_coefficients(matrix) if kind == "xor" else \
        gfmat.gf_matrix_to_bits(matrix)
    return torch.from_numpy(host).to(dev)


def _run(name: str, op, data, plain: bool):
    mod = KERNELS[name]["module"]
    if name == "gf_xor":
        return (mod.gf_matmul_xor_torch if plain else mod.gf_matmul_xor_cuda)(
            op, data)
    if name == "gf_sel":
        return (mod.gf_matmul_sel_torch if plain else mod.gf_matmul_sel_cuda)(
            op, data)
    return (mod.gf_matmul_bits_torch if plain else mod.gf_matmul_bits_cuda)(
        op, data)


def _event_ms(fn, flush: torch.Tensor) -> float:
    """One CUDA-event timing of fn(). A read of `flush` (1 GiB, ~0.3 ms)
    is queued first: it evicts fn's inputs from L2 without leaving dirty
    lines behind, and it keeps the card busy while the host queues the
    events and fn, so the events bracket fn's device time rather than the
    host's launch overhead."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    flush.sum()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _time_turns(fns, flush: torch.Tensor, runs: int = 40,
                warmup_s: float = 1.0) -> list[list[float]]:
    """CUDA-event times of each of `fns`, taken in turns (forward, then
    backward, then forward, ...) after at least `warmup_s` seconds of all
    of them running, so clock ramp-up and drift fall on all alike."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warmup_s:
        for fn in fns:
            fn()
        torch.cuda.synchronize()
    times = [[] for _ in fns]
    for i in range(runs):
        order = list(zip(fns, times))
        for fn, out in (order if i % 2 == 0 else order[::-1]):
            out.append(_event_ms(fn, flush))
    return times


def _quartiles(xs: list[float]) -> str:
    q = statistics.quantiles(xs, n=4)
    return f"{q[0]:.4f}/{q[1]:.4f}/{q[2]:.4f}"


def _sm_clock() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def _matrices() -> dict[str, np.ndarray]:
    """K1's and K2's matrices: the RS(10,4) encode, the fused decode of
    the rebuild ([3, 10], shards REBUILD_LOST lost), of a degraded read
    ([1, 10], shard DEGRADED_SHARD lost), of the server's degraded GET
    ([4, 10], the rows GET_UNREAD), of the Store's degraded reads with
    REBUILD_LOST gone (an interval spanning both lost data shards: [2,
    10]), the RS(6,3) encode of the cluster's config #5 ([3, 6]), and
    the mesh phase's pm_mbr_6_3_5 generator ([30, 12]) and repair of
    node PM_FAILED from its first d helpers ([5, 5])."""
    def fused(lost, gone=None):
        present = tuple(i for i in range(14) if i not in (gone or lost))
        return gfmat.fused_reconstruct_matrix(10, 4, present, lost)[0]
    pm = geometry.get("pm_mbr_6_3_5")
    helpers = [i for i in range(pm.n_nodes) if i != PM_FAILED][:pm.d_helpers]
    return {"encode": gf256.parity_matrix(10, 4), "decode": fused(REBUILD_LOST),
            "degraded": fused((DEGRADED_SHARD,)),
            "degraded GET": fused(GET_UNREAD),
            "degraded store": fused(REBUILD_LOST[:2], REBUILD_LOST),
            "encode 6+3": gf256.parity_matrix(6, 3),
            "pm_mbr encode": pm.generator_matrix(),
            "pm_mbr repair": gf256.gf_mat_inv(pm.psi[helpers])}


def _check_equal(name: str, what: str, op, data) -> int:
    """Kernel against plain version on `data`, byte for byte; the largest
    absolute difference (0, or it raises)."""
    got = _run(name, op, data, plain=False)
    want = _run(name, op, data.contiguous(), plain=True)
    torch.cuda.synchronize()
    err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max().item()) \
        if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"{name} {what}: kernel differs from plain "
                             f"(max {err})")
    return err


def check_identity(dev) -> None:
    """K2's fragment layout first: the GF identity [10, 10] returns its
    input, and each row of it, as a [1, 10] matrix, returns one input
    row, at a width with a ragged tail."""
    data = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, size=(10, 4096 + 37), dtype=np.uint8)).to(dev)
    eye = np.eye(10, dtype=np.uint8)
    got = _run("gf_bits", _operand("bits", eye, dev), data, plain=False)
    if not torch.equal(got, data):
        raise AssertionError("gf_bits: the identity does not return its "
                             "input")
    for i in range(10):
        got = _run("gf_bits", _operand("bits", eye[i:i + 1], dev), data,
                   plain=False)
        if not torch.equal(got[0], data[i]):
            raise AssertionError(f"gf_bits: identity row {i} does not "
                                 f"return input row {i}")
    log("kernels", "gf_bits: identity [10,10] returns its input, each "
                   "[1,10] identity row its input row")


def check_kernels(dev, names=tuple(KERNELS)) -> dict:
    """Each of `names` against its plain version on the card, byte for
    byte: the shapes and matrices of PRs 1-2, then the layouts the
    redesigned kernels realign. Returns {kernel: max_abs_err}."""
    rng = np.random.default_rng(2024)
    mats = _matrices()
    if "gf_bits" in names:
        check_identity(dev)
    wide = rng.integers(0, 256, size=(8, 40), dtype=np.uint8)
    matrices = {"encode[4,10]": mats["encode"], "decode[3,10]": mats["decode"],
                "wide[8,40]": wide}
    sel = {f"{n}{list(m.shape)}": m for n, m in sel_matrices().items()}
    worst = {}
    for name, spec in KERNELS.items():
        if name not in names:
            continue
        err = 0
        checked = 0
        widths = (MIB, MIB + 4, 4095, 1, STACKED_WIDTH)
        for mname, mat in (sel if name == "gf_sel" else matrices).items():
            op = _operand(spec["form"], mat, dev)
            c = mat.shape[1]
            for b in widths:
                data = torch.from_numpy(
                    rng.integers(0, 256, size=(c, b), dtype=np.uint8)).to(dev)
                err = max(err, _check_equal(name, f"{mname} B={b}", op, data))
                checked += 1
            # a column slice of a wider buffer: rows strided, bytes unit-stride
            base = torch.from_numpy(rng.integers(
                0, 256, size=(c, 8192 + 13), dtype=np.uint8)).to(dev)
            err = max(err, _check_equal(name, f"{mname} row-strided", op,
                                        base[:, 5:5 + 8192]))
            checked += 1
        # a transposed (byte-strided) input is refused, not copied
        op = _operand(spec["form"], mats["encode"], dev)
        bad = torch.zeros((4096, 10), dtype=torch.uint8, device=dev).t()
        try:
            _run(name, op, bad, plain=False)
        except ValueError:
            pass
        else:
            raise AssertionError(f"{name} accepted a byte-strided input")
        # golden RS(10,4) shard hashes through the kernel
        g = np.random.default_rng(0xEC).integers(0, 256, size=(10, 4096),
                                                 dtype=np.uint8)
        parity = _run(name, op, torch.from_numpy(g).to(dev), plain=False)
        shards = np.concatenate([g, parity.cpu().numpy()])
        hashes = [hashlib.sha256(s.tobytes()).hexdigest() for s in shards]
        if hashes != GOLDEN_SHARD_SHA256:
            raise AssertionError(f"{name}: golden shard hashes differ")
        log("kernels", f"{name}: {checked} shapes byte-identical to plain, "
                       f"transposed input refused, golden hashes match")
        worst[name] = err

    # the layouts the kernels realign: every row offset, narrow widths, spans
    # that end at their allocation's last byte; and K1 and K2 at every R
    rs_mats = {"encode[4,10]": mats["encode"], "decode[3,10]": mats["decode"],
               "degraded[1,10]": mats["degraded"]}
    for name, mats_of in (("gf_xor", rs_mats), ("gf_bits", rs_mats),
                          ("gf_sel", sel)):
        if name not in names:
            continue
        err = worst[name]
        checked = 0
        for mname, mat in mats_of.items():
            op = _operand(KERNELS[name]["form"], mat, dev)
            c = mat.shape[1]
            # row stride 8221 (no multiple of 16): at offset o the rows start
            # at o, o + 8221, ...; the output [R, b] is misaligned too
            base = torch.from_numpy(rng.integers(
                0, 256, size=(c, 8221), dtype=np.uint8)).to(dev)
            for off in range(16):
                err = max(err, _check_equal(name, f"{mname} offset {off}", op,
                                            base[:, off:off + 8189]))
                # the last row's span ends at its allocation's last byte
                err = max(err, _check_equal(name, f"{mname} offset {off} to "
                                            f"the end", op, base[:, off:]))
                checked += 2
            for b in range(1, 48):
                data = torch.from_numpy(rng.integers(
                    0, 256, size=(c, b), dtype=np.uint8)).to(dev)
                err = max(err, _check_equal(name, f"{mname} B={b}", op, data))
                checked += 1
        if name in ("gf_xor", "gf_bits"):
            for r in (1, 2, 3, 4, 5, 6, 7, 8, 14):
                mat = rng.integers(0, 256, size=(r, 10), dtype=np.uint8)
                op = _operand(KERNELS[name]["form"], mat, dev)
                for b in (64 * 1024 + 3, DEGRADED_WIDTH):
                    data = torch.from_numpy(rng.integers(
                        0, 256, size=(10, b), dtype=np.uint8)).to(dev)
                    err = max(err, _check_equal(name, f"R={r} B={b}", op,
                                                data))
                    checked += 1
        extra = ", R = 1-8 and 14" if name != "gf_sel" else ""
        if name == "gf_bits":
            # C past a 4-byte word and past one 256-bit k-step
            for c in (1, 3, 17, 33, 64):
                mat = rng.integers(0, 256, size=(4, c), dtype=np.uint8)
                op = _operand("bits", mat, dev)
                base = torch.from_numpy(rng.integers(
                    0, 256, size=(c, 8221), dtype=np.uint8)).to(dev)
                dense = torch.from_numpy(rng.integers(
                    0, 256, size=(c, 65539), dtype=np.uint8)).to(dev)
                for what, data in (("B=65539", dense),
                                   ("offset 7 to the end", base[:, 7:]),
                                   ("offset 3 B=37", base[:, 3:40])):
                    err = max(err, _check_equal(name, f"[4,{c}] {what}", op,
                                                data))
                    checked += 1
            extra += ", C in {1, 3, 17, 33, 64}"
        log("kernels", f"{name}: {checked} more layouts byte-identical to "
                       f"plain (row offsets 0-15 at row stride 8221, spans "
                       f"ending at the allocation's end, widths 1-47{extra})")
        worst[name] = err
    return worst


def baseline_kernels(root: str, workdir: str | None,
                     names=tuple(KERNELS)) -> dict:
    """K1 (gf_xor.cu), K2 (gf_bits.cu) and K3 (gf_sel.cu for the RS(10,4)
    encode matrix) of another checkout at `root`, built with this
    checkout's nvcc flags and bound by the same C interface: {kernel:
    fn(operand, data) -> out}, to time another version beside this one in
    the same run. The other K2 is handed its own operand: an earlier K2
    (before its tensor-core form, which takes rs_bits.mma_words) takes the
    int8 bit matrix itself."""
    import ctypes

    csrc = os.path.join(root, "seaweedfs_tpu_torch", "ops", "csrc")
    out_dir = tempfile.mkdtemp(prefix="baseline-", dir=workdir)
    unit = os.path.join(out_dir, "gf_sel_rs_10_4.cu")
    with open(unit, "w") as f:
        f.write(_build.specialised_unit("gf_sel.cu", gf256.parity_matrix(10, 4)))
    jobs = {name: subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
         os.path.join(out_dir, f"{name}.so"), *inputs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, inputs in (("gf_xor", [os.path.join(csrc, "gf_xor.cu")]),
                             ("gf_bits", [os.path.join(csrc, "gf_bits.cu")]),
                             ("gf_sel", ["-I", csrc, unit]))
        if name in names}
    libs = {}
    for name, proc in jobs.items():
        text, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"baseline {name} failed to build:\n{text}")
        libs[name] = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name in ("gf_xor", "gf_bits"):
        if name in libs:
            getattr(libs[name], f"{name}_launch").argtypes = [
                vp, vp, ll, vp, ll, i, i, ll, i, vp]
    if "gf_sel" in libs:
        libs["gf_sel"].gf_sel_launch.argtypes = [vp, ll, vp, ll, ll, i, vp]
    with open(os.path.join(csrc, "gf_bits.cu")) as f:
        packed_k2 = "m16n8k256" in f.read()

    def launch(name, *args):
        code = getattr(libs[name], f"{name}_launch")(*args)
        if code != 0:
            raise RuntimeError(f"baseline {name} launch failed: {code}")

    def xor(coef, data):
        out = torch.empty((coef.shape[0], data.shape[1]), dtype=torch.uint8,
                          device=data.device)
        launch("gf_xor", coef.data_ptr(), data.data_ptr(), data.stride(0),
               out.data_ptr(), out.stride(0), coef.shape[0], data.shape[0],
               data.shape[1], data.device.index,
               torch.cuda.current_stream(data.device).cuda_stream)
        return out

    def bits(mbits, data):
        op = rs_bits.mma_words(mbits) if packed_k2 else mbits
        out = torch.empty((mbits.shape[0] // 8, data.shape[1]),
                          dtype=torch.uint8, device=data.device)
        launch("gf_bits", op.data_ptr(), data.data_ptr(), data.stride(0),
               out.data_ptr(), out.stride(0), out.shape[0], data.shape[0],
               data.shape[1], data.device.index,
               torch.cuda.current_stream(data.device).cuda_stream)
        return out

    def sel(matrix, data):
        if not np.array_equal(matrix, gf256.parity_matrix(10, 4)):
            raise ValueError("the baseline K3 is built for RS(10,4) only")
        out = torch.empty((4, data.shape[1]), dtype=torch.uint8,
                          device=data.device)
        launch("gf_sel", data.data_ptr(), data.stride(0), out.data_ptr(),
               out.stride(0), data.shape[1], data.device.index,
               torch.cuda.current_stream(data.device).cuda_stream)
        return out

    return {name: fn for name, fn in
            (("gf_xor", xor), ("gf_bits", bits), ("gf_sel", sel))
            if name in libs}


def time_shapes(dev, card: str, baseline: dict | None = None,
                names=tuple(KERNELS)) -> dict:
    """CUDA-event times of each kernel and its plain version at the shapes
    the main path launches (TIMED_SHAPES), with each shape's bytes bound;
    at the degraded-read shape also an empty kernel's time, its floor; and,
    given `baseline` (baseline_kernels), the other version's K1 and K3 in
    the same turns, after a byte-for-byte check against the plain one."""
    rng = np.random.default_rng(7)
    mats = _matrices()
    flush = torch.zeros(1024 * MIB, dtype=torch.uint8, device=dev)
    rate = memory_rate(card)
    out = {}
    for name, label, mname, b in TIMED_SHAPES:
        if name not in names:
            continue
        mat = mats[mname]
        op = _operand(KERNELS[name]["form"], mat, dev)
        r, c = mat.shape
        data = torch.from_numpy(
            rng.integers(0, 256, size=(c, b), dtype=np.uint8)).to(dev)
        fns = {"kernel": lambda: _run(name, op, data, plain=False),
               "plain": lambda: _run(name, op, data, plain=True)}
        if mname == "degraded":
            fns["floor"] = lambda: rs_xor.launch_empty(dev)
        if baseline and name in baseline:
            other = baseline[name]
            if not torch.equal(other(op, data), fns["plain"]()):
                raise AssertionError(f"baseline {name} {label} differs from "
                                     f"plain")
            fns["baseline"] = lambda: other(op, data)
        times = dict(zip(fns, _time_turns(list(fns.values()), flush)))
        moved = (c + r) * b
        row = dict(kernel=name, shape=f"{label} x {b} B",
                   ms=statistics.median(times["kernel"]),
                   plain_ms=statistics.median(times["plain"]),
                   bound_ms=moved / rate * 1e3,
                   floor_ms=statistics.median(times["floor"])
                   if "floor" in times else None,
                   baseline_ms=statistics.median(times["baseline"])
                   if "baseline" in times else None)
        floor = "" if row["floor_ms"] is None else (
            f", empty kernel {row['floor_ms']:.6f} ms (quartiles "
            f"{_quartiles(times['floor'])})")
        if row["baseline_ms"] is not None:
            floor += (f", baseline {row['baseline_ms']:.6f} ms (quartiles "
                      f"{_quartiles(times['baseline'])})")
        log("kernels", f"{name} {row['shape']}: median {row['ms']:.6f} ms "
                       f"(quartiles {_quartiles(times['kernel'])}), "
                       f"{row['ms'] / row['bound_ms']:.2f}x the bytes bound "
                       f"{row['bound_ms']:.6f} ms = {moved} B at {rate:.3g} "
                       f"B/s; plain {row['plain_ms']:.6f} ms{floor}; SM "
                       f"clock, max: {_sm_clock()}; on {card}")
        out[(name, label)] = row
    return out


# -- pipeline -----------------------------------------------------------------


def make_volume(base: str, size_bytes: int, seed: int) -> list[tuple]:
    """Seeded .dat + .idx: an 8-byte superblock, then padded needle records
    of 1-64 KiB of random bytes. Returns [(needle_id, offset, length)]."""
    rng = np.random.default_rng(seed)
    needles = []
    offset = 8
    nid = 1
    while offset < size_bytes:
        size = int(rng.integers(1, 64 * 1024 + 1))
        length = types.actual_size(size)
        needles.append((nid, offset, size, length))
        offset += length
        nid += 1
    dat = rng.integers(0, 256, size=offset, dtype=np.uint8)
    dat[:8] = np.frombuffer(b"\x03" + bytes(7), np.uint8)
    dat.tofile(base + ".dat")
    ids = np.array([n[0] for n in needles], np.uint64)
    offs = np.array([types.offset_to_stored(n[1]) for n in needles], np.uint64)
    sizes = np.array([n[2] for n in needles], np.int32)
    with open(base + ".idx", "wb") as f:
        f.write(idx.pack_index_arrays(ids, offs, sizes))
    return [(n[0], n[1], n[3]) for n in needles]


def _hash_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(16 * MIB):
            h.update(chunk)
    return h.hexdigest()


def shard_hashes(base: str, geo: Geometry) -> list[str]:
    return [_hash_file(geo.shard_file_name(base, i))
            for i in range(geo.total_shards)]


def cpu_oracle_hashes(base: str, geo: Geometry, workdir: str) -> list[str]:
    """Shard sha256s of the same volume through the port's numpy coder."""
    odir = tempfile.mkdtemp(prefix="oracle-", dir=workdir)
    try:
        obase = os.path.join(odir, "v")
        os.symlink(os.path.abspath(base + ".dat"), obase + ".dat")
        coder = new_coder(geo.data_shards, geo.parity_shards, backend="cpu")
        ec_files.write_ec_files(obase, coder, geo)
        return shard_hashes(obase, geo)
    finally:
        shutil.rmtree(odir)


def check_shards(phase: str, base: str, geo: Geometry,
                 workdir: str) -> tuple[list[str], float]:
    """The shard sha256s of `base`, held against the numpy cpu coder's;
    -> (hashes, seconds the oracle took)."""
    hashes = shard_hashes(base, geo)
    t0 = time.perf_counter()
    oracle = cpu_oracle_hashes(base, geo, workdir)
    oracle_s = time.perf_counter() - t0
    if hashes != oracle:
        bad = [i for i in range(geo.total_shards) if hashes[i] != oracle[i]]
        raise AssertionError(f"{phase}: shards {bad} of {base} differ from "
                             f"the cpu coder")
    return hashes, oracle_s


def encode_detail(st) -> str:
    """Where one write_ec_files call spent its time (its EncodeStats)."""
    return (f"{st.batches} slabs; reader: read {st.read_s:.3f} s, encode "
            f"calls {st.dispatch_s:.3f} s; coordinator: device wait "
            f"{st.device_wait_s:.3f} s; writers: {st.write_s:.3f} thread-s")


def rebuild_checked(phase: str, base: str, geo: Geometry, coder,
                    hashes: list[str], card: str, then=None) -> float:
    """Rebuild the missing shards REBUILD_LOST (then `then(base)` inside
    the timing), check them sha-identical to `hashes`; -> GB/s of
    survivors read."""
    rstats: dict = {}
    t0 = time.perf_counter()
    rebuilt = ec_files.rebuild_ec_files(base, coder, geo, stats=rstats)
    if then is not None:
        then(base)
    torch.cuda.synchronize()
    reb_s = time.perf_counter() - t0
    if tuple(rebuilt) != REBUILD_LOST:
        raise AssertionError(f"{phase}: rebuilt {rebuilt}, not {REBUILD_LOST}")
    if shard_hashes(base, geo) != hashes:
        raise AssertionError(f"{phase}: rebuilt shards differ")
    gbps = rstats["survivor_bytes_read"] / reb_s / 1e9
    log(phase, f"rebuild of shards {list(REBUILD_LOST)}: {reb_s:.3f} s = "
               f"{gbps:.3f} GB/s of survivors read end to end on {card}; "
               f"sha-identical")
    return gbps


def encode_and_rebuild(phase: str, base: str, geo: Geometry, coder,
                       workdir: str, card: str) -> tuple[list[str], dict]:
    dat_bytes = os.path.getsize(base + ".dat")
    t0 = time.perf_counter()
    stats = ec_files.write_ec_files(base, coder, geo)
    ec_files.write_sorted_file_from_idx(base)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    hashes, oracle_s = check_shards(phase, base, geo, workdir)
    log(phase, f"encode of {dat_bytes} B: {enc_s:.3f} s = "
               f"{dat_bytes / enc_s / 1e9:.3f} GB/s end to end on {card} "
               f"({encode_detail(stats)}); 14 shard sha256s match the "
               f"numpy cpu coder ({oracle_s:.1f} s)")
    for i in REBUILD_LOST:
        os.remove(geo.shard_file_name(base, i))
    rebuild_gbps = rebuild_checked(phase, base, geo, coder, hashes, card)
    return hashes, dict(encode_gbps=dat_bytes / enc_s / 1e9,
                        rebuild_gbps=rebuild_gbps)


def split_by_lost(geo: Geometry, est: int, extents, lost) -> tuple[list,
                                                                  list]:
    """(item, offset, length) extents of an EC volume of estimated .dat
    size `est`, split into the items whose bytes lie on a shard in `lost`
    and the rest; -> (touching, others)."""
    touching, others = [], []
    for item, off, length in extents:
        ids = {iv.to_shard_id_and_offset(geo)[0]
               for iv in locate_data(geo, est, off, length)}
        (touching if ids & set(lost) else others).append(item)
    return touching, others


def degraded_reads(base: str, geo: Geometry, coder, needles,
                   seed: int) -> tuple[int, int]:
    os.remove(geo.shard_file_name(base, DEGRADED_SHARD))
    vol = EcVolume(base, coder, geo=geo)
    try:
        touching, others = split_by_lost(
            geo, vol.dat_size_estimate,
            ((n, n[1], n[2]) for n in needles), (DEGRADED_SHARD,))
        rng = np.random.default_rng(seed)
        extra = max(MIN_HEALTHY_READS, MIN_READS - len(touching))
        pick = rng.choice(len(others), size=min(len(others), extra),
                          replace=False)
        chosen = touching + [others[i] for i in sorted(pick)]
        with open(base + ".dat", "rb") as f, \
                mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as dat:
            for nid, off, length in chosen:
                got = vol.read_needle_blob(nid)
                if got != dat[off:off + length]:
                    raise AssertionError(f"needle {nid} differs from its "
                                         f".dat extent")
        return len(touching), len(chosen)
    finally:
        vol.close()


def pipeline(phase: str, kernel: str, volume_mb: int, seed: int, degraded: bool,
             workdir: str, card: str) -> dict:
    os.environ["SEAWEEDFS_TORCH_KERNEL"] = KERNELS[kernel]["form"]
    geo = Geometry()
    vdir = tempfile.mkdtemp(prefix=f"{phase}-", dir=workdir)
    try:
        base = os.path.join(vdir, "1")
        t0 = time.perf_counter()
        needles = make_volume(base, volume_mb * MIB, seed)
        log(phase, f"volume: {len(needles)} needles, "
                   f"{os.path.getsize(base + '.dat')} B in "
                   f"{time.perf_counter() - t0:.1f} s")
        coder = new_coder()
        for spec in KERNELS.values():
            spec["module"].KERNEL.reset()
        _, rates = encode_and_rebuild(phase, base, geo, coder, workdir, card)
        if degraded:
            touching, n = degraded_reads(base, geo, coder, needles, seed)
            log(phase, f"{n} needle reads byte-exact, {touching} of them "
                       f"degraded (touching lost shard {DEGRADED_SHARD})")
        counts = {k: spec["module"].KERNEL.launches
                  for k, spec in KERNELS.items()}
        if counts[kernel] <= 0:
            raise AssertionError(f"{phase}: {kernel} was never launched")
        log(phase, f"launches: {counts}; gf_xor by R: "
                   f"{dict(sorted(rs_xor.KERNEL.launches_by.items()))}")
        return dict(launches=counts[kernel], **rates)
    finally:
        shutil.rmtree(vdir)
        os.environ.pop("SEAWEEDFS_TORCH_KERNEL", None)


def _all_at_once(fn, items) -> list:
    """fn(item) for every item, one thread each, started together; the
    results in order. The first error raises."""
    results = [None] * len(items)
    errors = []

    def run(i, item):
        try:
            results[i] = fn(item)
        except BaseException as e:  # raised below, on the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, item))
               for i, item in enumerate(items)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def _lane_counts() -> dict:
    """Slabs and batches per lane of the card's coder so far (its batches
    carry reason single_device; the numpy oracle's say cpu_explicit)."""
    return {lane: (ec_stats.EC_DISPATCH_SLABS.value(lane=lane),
                   ec_stats.EC_DISPATCH_BATCHES.value(
                       lane=lane, reason="single_device"),
                   ec_stats.EC_DISPATCH_WINDOW_WAIT.snapshot(lane=lane))
            for lane in ("encode", "reconstruct")}


def log_lanes(phase: str, spans) -> None:
    """One line per (what, lane, before, after) span of _lane_counts():
    slabs, batches, batch factor and mean queue wait on that lane."""
    for what, lane, a, b in spans:
        n_sl = b[lane][0] - a[lane][0]
        n_b = b[lane][1] - a[lane][1]
        wait = b[lane][2]["sum"] - a[lane][2]["sum"]
        log(phase, f"{what}: {lane} lane {n_sl:.0f} slabs in {n_b:.0f} "
                   f"batches, batch factor {n_sl / max(n_b, 1):.3f}, mean "
                   f"queue wait {wait / max(n_sl, 1) * 1e3:.3f} ms")


def pipeline_sched(volume_mb: int, n_volumes: int, seed: int, workdir: str,
                   card: str) -> dict:
    """BASELINE config #4: `n_volumes` volumes encoding at once on one
    coder, their slabs meeting in the dispatch scheduler's encode lane
    (K3, SEAWEEDFS_TORCH_KERNEL=sel); then concurrent rebuilds and
    degraded reads on the reconstruct lanes (K1)."""
    phase = "pipeline-sched"
    os.environ["SEAWEEDFS_TORCH_KERNEL"] = "sel"
    geo = Geometry()
    vdir = tempfile.mkdtemp(prefix=f"{phase}-", dir=workdir)
    try:
        bases = [os.path.join(vdir, str(v + 1)) for v in range(n_volumes)]
        t0 = time.perf_counter()
        needles = [make_volume(b, volume_mb * MIB, seed + v)
                   for v, b in enumerate(bases)]
        dat_bytes = sum(os.path.getsize(b + ".dat") for b in bases)
        log(phase, f"{n_volumes} volumes: {sum(map(len, needles))} needles, "
                   f"{dat_bytes} B in {time.perf_counter() - t0:.1f} s")
        coder = new_coder()
        for spec in KERNELS.values():
            spec["module"].KERNEL.reset()
        lanes0 = _lane_counts()

        def encode(base):
            st = ec_files.write_ec_files(base, coder, geo)
            ec_files.write_sorted_file_from_idx(base)
            return st

        t0 = time.perf_counter()
        enc_stats = _all_at_once(encode, bases)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        lanes1 = _lane_counts()
        # the oracles run at once: numpy's table lookups and XORs leave
        # the interpreter lock, so they overlap on the host's cores
        t0 = time.perf_counter()
        hashes = [h for h, _ in _all_at_once(
            lambda b: check_shards(phase, b, geo, workdir), bases)]
        oracle_s = time.perf_counter() - t0
        tot = {f: sum(getattr(st, f) for st in enc_stats)
               for f in ("bytes", "batches", "wall_s", "read_s",
                         "dispatch_s", "device_wait_s", "write_s")}
        log(phase, f"encode of {n_volumes} x {volume_mb} MiB at once: "
                   f"{dat_bytes} B in {enc_s:.3f} s = "
                   f"{dat_bytes / enc_s / 1e9:.3f} GB/s aggregate end to end "
                   f"on {card}; EncodeStats summed over the {n_volumes} "
                   f"pipelines: {tot['batches']} slabs, wall "
                   f"{tot['wall_s']:.3f} s, read {tot['read_s']:.3f} s, "
                   f"submit {tot['dispatch_s']:.3f} s, device wait "
                   f"{tot['device_wait_s']:.3f} s, write "
                   f"{tot['write_s']:.3f} thread-s; "
                   f"{n_volumes * geo.total_shards} shard sha256s match the "
                   f"numpy cpu coder ({oracle_s:.1f} s, {n_volumes} at once)")

        def rebuild(base):
            for i in REBUILD_LOST:
                os.remove(geo.shard_file_name(base, i))
            rstats: dict = {}
            got = ec_files.rebuild_ec_files(base, coder, geo, stats=rstats)
            if tuple(got) != REBUILD_LOST:
                raise AssertionError(f"{phase}: rebuilt {got}")
            return rstats["survivor_bytes_read"]

        t0 = time.perf_counter()
        read_b = sum(_all_at_once(rebuild, bases))
        torch.cuda.synchronize()
        reb_s = time.perf_counter() - t0
        if [shard_hashes(b, geo) for b in bases] != hashes:
            raise AssertionError(f"{phase}: rebuilt shards differ")
        log(phase, f"rebuild of shards {list(REBUILD_LOST)} of all "
                   f"{n_volumes} at once: {reb_s:.3f} s = "
                   f"{read_b / reb_s / 1e9:.3f} GB/s of survivors read "
                   f"aggregate end to end on {card}; sha-identical")
        lanes2 = _lane_counts()

        def degraded(v):
            return degraded_reads(bases[v], geo, coder, needles[v], seed + v)

        t0 = time.perf_counter()
        reads = _all_at_once(degraded, list(range(n_volumes)))
        read_s = time.perf_counter() - t0
        lanes3 = _lane_counts()
        log(phase, f"{sum(n for _, n in reads)} needle reads by "
                   f"{n_volumes} readers at once byte-exact in "
                   f"{read_s:.3f} s, {sum(t for t, _ in reads)} of them "
                   f"degraded (touching lost shard {DEGRADED_SHARD})")

        counts = {k: spec["module"].KERNEL.launches
                  for k, spec in KERNELS.items()}
        enc_slabs = lanes1["encode"][0] - lanes0["encode"][0]
        enc_batches = lanes1["encode"][1] - lanes0["encode"][1]
        rec_batches = lanes3["reconstruct"][1] - lanes1["reconstruct"][1]
        log_lanes(phase, (("encode", "encode", lanes0, lanes1),
                          ("rebuild", "reconstruct", lanes1, lanes2),
                          ("degraded reads", "reconstruct", lanes2, lanes3)))
        arena = ec_stats.ec_dispatch_stats()["arena"]
        log(phase, f"launches: {counts}; gf_xor by R: "
                   f"{dict(sorted(rs_xor.KERNEL.launches_by.items()))}; "
                   f"stack arena {arena}")
        if counts["gf_sel"] <= 0:
            raise AssertionError(f"{phase}: gf_sel was never launched")
        if counts["gf_sel"] != enc_batches:
            raise AssertionError(f"{phase}: {counts['gf_sel']} gf_sel "
                                 f"launches for {enc_batches} encode batches")
        if not enc_slabs > enc_batches:
            raise AssertionError(f"{phase}: no encode batch stacked more "
                                 f"than one slab ({enc_slabs} slabs, "
                                 f"{enc_batches} batches)")
        if counts["gf_xor"] <= 0 or counts["gf_xor"] != rec_batches:
            raise AssertionError(f"{phase}: {counts['gf_xor']} gf_xor "
                                 f"launches for {rec_batches} reconstruct "
                                 f"batches")
        return dict(launches=counts["gf_sel"],
                    encode_gbps=dat_bytes / enc_s / 1e9,
                    rebuild_gbps=read_b / reb_s / 1e9,
                    batch_factor=enc_slabs / enc_batches)
    finally:
        shutil.rmtree(vdir)
        os.environ.pop("SEAWEEDFS_TORCH_KERNEL", None)


# -- mesh -----------------------------------------------------------------------


MESH_VOLUMES = 4
MESH_VOLUME_MB = 64
MESH_LRC_MB = 16
MESH_REBUILD_BATCH = MIB  # every rebuild slab 1 MiB wide: one uniform lane
MESH_WINDOW_MS = "20"  # lets the four rebuilds' slabs meet in one flush
MESH_FLIP = (7, 12345, 0x5A)  # (shard, byte, mask) of the probe's flip


def _mesh_step(phase: str, what: str, t0: float) -> float:
    s = time.perf_counter() - t0
    log(phase, f"{what}: {s:.3f} s")
    return s


def _check_device(phase: str, want: int) -> None:
    """The launchers give the calling thread its current device back."""
    got = torch.cuda.current_device()
    if got != want:
        raise AssertionError(f"{phase}: a launch moved the current CUDA "
                             f"device from {want} to {got}")


def mesh_phase(seed: int, workdir: str, card: str,
               dev: torch.device = torch.device("cuda", 0)) -> dict:
    """The multi-GPU coder (parallel/mesh.py) over the one card listed
    twice: entry() and dryrun_multichip(2); ShardedCoder with K1 ("xor")
    and K2 ("bits"): the column split, reconstruct_stacked, the V-axis
    split and the parity probe against the single-device RSCodecTorch,
    the plain version and the numpy coder; four volumes encoding at once
    through the scheduler's per-chip lanes and their concurrent 3-shard
    rebuild (the V-split branch); an lrc_10_2_2 volume and a pm_mbr_6_3_5
    stripe; the native host coders. Two entries of one card share its
    SMs: the phase checks the splits and lanes, it measures no multi-GPU
    speed."""
    from seaweedfs_tpu_torch import entry
    from seaweedfs_tpu_torch.ops import rs_native
    from seaweedfs_tpu_torch.parallel import mesh

    phase = "mesh"
    torch.cuda.set_device(dev)
    here = torch.cuda.current_device()
    mesh2 = mesh.make_mesh([dev, dev])
    rng = np.random.default_rng(seed)
    cpu = new_coder(backend="cpu")
    data = rng.integers(0, 256, (10, MESH_WIDTH), dtype=np.uint8)
    shards = np.concatenate([data, cpu.encode_parity(data)])
    present = tuple(i for i in range(14) if i not in REBUILD_LOST)
    survivors = shards[list(present)]
    quarter = MESH_WIDTH // 4
    vstack = np.stack([survivors[:, i * quarter:(i + 1) * quarter]
                       for i in range(4)])
    bad = shards.copy()
    row, col, mask = MESH_FLIP
    bad[row, col] ^= mask
    bad_probe = int((cpu.encode_parity(bad[:10]) ^ bad[10:]).max())
    # the single-device codec's and the plain versions' answers, computed
    # before the counts start: comparison launches do not count
    single = RSCodecTorch(10, 4, device=dev)
    on_card = torch.from_numpy(data).to(dev)
    expect = {}
    for kernel, name in (("xor", "gf_xor"), ("bits", "gf_bits")):
        os.environ["SEAWEEDFS_TORCH_KERNEL"] = kernel
        try:
            expect[kernel] = dict(
                parity=single.encode_parity(data).cpu().numpy(),
                rows=single.reconstruct_stacked(
                    present, survivors)[1].cpu().numpy(),
                plain=_run(name, _operand(kernel, gf256.parity_matrix(
                    10, 4), dev), on_card, plain=True).cpu().numpy())
        finally:
            os.environ.pop("SEAWEEDFS_TORCH_KERNEL", None)
    torch.cuda.synchronize()
    for spec in KERNELS.values():
        spec["module"].KERNEL.reset()
    steps = {}
    vdir = tempfile.mkdtemp(prefix=f"{phase}-", dir=workdir)
    old_window = os.environ.get("SWFS_EC_DISPATCH_WINDOW_MS")
    os.environ["SWFS_EC_DISPATCH_WINDOW_MS"] = MESH_WINDOW_MS
    try:
        # 1. the entry points
        t0 = time.perf_counter()
        fn, (example,) = entry.entry()
        out = fn(example).cpu().numpy()
        if not (np.array_equal(out[:10], example)
                and np.array_equal(out[10:], cpu.encode_parity(example))):
            raise AssertionError(f"{phase}: entry() differs from the cpu "
                                 f"coder")
        entry.dryrun_multichip(2)
        _check_device(phase, here)
        steps["entry"] = _mesh_step(
            phase, "entry() (K2) and dryrun_multichip(2) over [cuda:0, "
                   "cuda:0] (encode, 4-shard reconstruct, probe, file "
                   "pipeline against the cpu coder)", t0)

        # 2. the splits, with each kernel
        for kernel in ("xor", "bits"):
            t0 = time.perf_counter()
            coder = mesh.ShardedCoder(10, 4, mesh=mesh2, kernel=kernel)
            parity = coder.encode_parity(data).cpu().numpy()
            _check_device(phase, here)
            for what, want in (("the cpu coder", shards[10:]),
                               ("RSCodecTorch", expect[kernel]["parity"]),
                               ("the plain version", expect[kernel]["plain"])):
                if not np.array_equal(parity, want):
                    raise AssertionError(f"{phase}: {kernel} column split "
                                         f"differs from {what}")
            missing, rows = coder.reconstruct_stacked(present, survivors)
            rows = rows.cpu().numpy()
            if (missing != REBUILD_LOST
                    or not np.array_equal(rows, shards[list(REBUILD_LOST)])
                    or not np.array_equal(rows, expect[kernel]["rows"])):
                raise AssertionError(f"{phase}: {kernel} reconstruct_stacked "
                                     f"differs")
            missing, vrows = coder.reconstruct_stacked_vsharded(present,
                                                                vstack)
            vrows = vrows.cpu().numpy()
            for i in range(4):
                if not np.array_equal(
                        vrows[i], rows[:, i * quarter:(i + 1) * quarter]):
                    raise AssertionError(f"{phase}: {kernel} V-split slab "
                                         f"{i} differs")
            clean = int(coder.parity_probe(shards))
            flipped = int(coder.parity_checksum(bad))
            if clean != 0 or flipped != bad_probe or flipped == 0:
                raise AssertionError(f"{phase}: {kernel} probe {clean}, "
                                     f"{flipped} (want 0, {bad_probe})")
            _check_device(phase, here)
            steps[kernel] = _mesh_step(
                phase, f"ShardedCoder({kernel}): column split of [10, "
                       f"{MESH_WIDTH}], reconstruct_stacked and the V split "
                       f"of 4 slabs with {list(REBUILD_LOST)} lost, probe "
                       f"0 clean and {flipped} after a flip; equal to "
                       f"RSCodecTorch, the plain version and the cpu coder",
                t0)

        # 3. four volumes at once through the per-chip lanes, then their
        # rebuilds at once (the V split of a big uniform batch)
        geo = Geometry()
        bases = [os.path.join(vdir, str(v + 1)) for v in range(MESH_VOLUMES)]
        for v, b in enumerate(bases):
            make_volume(b, MESH_VOLUME_MB * MIB, seed + v)
        coder = mesh.ShardedCoder(10, 4, mesh=mesh2, kernel="xor")
        vsplits = []
        real_vsplit = coder.reconstruct_stacked_vsharded

        def counted_vsplit(*args, **kw):
            vsplits.append(np.asarray(args[1]).shape[0])
            return real_vsplit(*args, **kw)

        coder.reconstruct_stacked_vsharded = counted_vsplit
        slabs0 = ec_stats.EC_DISPATCH_SLABS.split_by("chip", lane="encode")
        batches0 = ec_stats.EC_DISPATCH_BATCHES.split_by("chip",
                                                         lane="encode")
        affine0 = ec_stats.EC_DISPATCH_BATCHES.value(reason="chip_affine")
        dat_bytes = sum(os.path.getsize(b + ".dat") for b in bases)
        t0 = time.perf_counter()
        _all_at_once(lambda b: ec_files.write_ec_files(b, coder, geo), bases)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        _check_device(phase, here)
        slabs = {c: n - slabs0.get(c, 0) for c, n in
                 ec_stats.EC_DISPATCH_SLABS.split_by(
                     "chip", lane="encode").items()}
        batches = {c: n - batches0.get(c, 0) for c, n in
                   ec_stats.EC_DISPATCH_BATCHES.split_by(
                       "chip", lane="encode").items()}
        affine = ec_stats.EC_DISPATCH_BATCHES.value(
            reason="chip_affine") - affine0
        if not (slabs.get("0", 0) > 0 and slabs.get("1", 0) > 0
                and batches.get("0", 0) > 0 and batches.get("1", 0) > 0
                and affine > 0):
            raise AssertionError(f"{phase}: encode slabs {slabs}, batches "
                                 f"{batches}, chip_affine {affine}: not on "
                                 f"both chip lanes")
        t1 = time.perf_counter()
        hashes = [h for h, _ in _all_at_once(
            lambda b: check_shards(phase, b, geo, workdir), bases)]
        oracle_s = time.perf_counter() - t1
        steps["encode"] = enc_s
        log(phase, f"encode of {MESH_VOLUMES} x {MESH_VOLUME_MB} MiB at once "
                   f"through the chip lanes: {dat_bytes} B in {enc_s:.3f} s; "
                   f"encode slabs by chip {slabs}, batches by chip "
                   f"{batches}, {affine:.0f} batches chip_affine; "
                   f"{MESH_VOLUMES * 14} shard sha256s match the numpy cpu "
                   f"coder ({oracle_s:.1f} s)")

        def rebuild(base):
            for i in REBUILD_LOST:
                os.remove(geo.shard_file_name(base, i))
            return ec_files.rebuild_ec_files(base, coder, geo,
                                             batch_size=MESH_REBUILD_BATCH)

        rec0 = ec_stats.EC_DISPATCH_BATCHES.split_by("chip",
                                                     lane="reconstruct")
        t0 = time.perf_counter()
        got = _all_at_once(rebuild, bases)
        torch.cuda.synchronize()
        reb_s = time.perf_counter() - t0
        rec = {c: n - rec0.get(c, 0) for c, n in
               ec_stats.EC_DISPATCH_BATCHES.split_by(
                   "chip", lane="reconstruct").items()}
        if any(tuple(g) != REBUILD_LOST for g in got):
            raise AssertionError(f"{phase}: rebuilt {got}")
        if [shard_hashes(b, geo) for b in bases] != hashes:
            raise AssertionError(f"{phase}: rebuilt shards differ")
        if not vsplits:
            raise AssertionError(f"{phase}: no rebuild batch took the V "
                                 f"split (reconstruct batches by chip {rec})")
        steps["rebuild"] = reb_s
        log(phase, f"rebuild of {list(REBUILD_LOST)} of all {MESH_VOLUMES} "
                   f"at once: {reb_s:.3f} s, sha-identical; {len(vsplits)} "
                   f"batches by the V split (slabs {sorted(vsplits)}), "
                   f"reconstruct batches by chip {rec}")

        # 4. the other geometries: an lrc_10_2_2 volume, a pm_mbr stripe
        t0 = time.perf_counter()
        lgeo = Geometry(code="lrc_10_2_2")
        lbase = os.path.join(vdir, "lrc")
        make_volume(lbase, MESH_LRC_MB * MIB, seed + 10)
        lcoder = mesh.ShardedCoder(10, 4, mesh=mesh2, geometry=lgeo.code)
        ec_files.write_ec_files(lbase, lcoder, lgeo)
        lhashes = shard_hashes(lbase, lgeo)
        obase = os.path.join(vdir, "lrc-oracle")
        os.symlink(os.path.abspath(lbase + ".dat"), obase + ".dat")
        ec_files.write_ec_files(obase, new_coder(
            10, 4, backend="cpu", geometry=lgeo.code), lgeo)
        if lhashes != shard_hashes(obase, lgeo):
            raise AssertionError(f"{phase}: lrc_10_2_2 shards differ from "
                                 f"the cpu coder")
        for i in (2, 11):
            os.remove(lgeo.shard_file_name(lbase, i))
        ec_files.rebuild_ec_files(lbase, lcoder, lgeo)
        if shard_hashes(lbase, lgeo) != lhashes:
            raise AssertionError(f"{phase}: lrc_10_2_2 rebuild differs")
        pm = geometry.get("pm_mbr_6_3_5")
        w = rng.integers(0, 256, (pm.message_symbols, MESH_WIDTH), np.uint8)
        nodes = mesh._apply_sharded(pm.generator_matrix(),
                                    ("pm_gen", pm.name), w, mesh2, "xor")
        nodes = nodes.cpu().numpy().reshape(pm.n_nodes, pm.sub_symbols, -1)
        if not np.array_equal(nodes, pm.encode_stripe(w)):
            raise AssertionError(f"{phase}: pm_mbr_6_3_5 encode differs")
        failed = PM_FAILED
        helpers = [i for i in range(pm.n_nodes) if i != failed][
            : pm.d_helpers]
        recv = np.stack([pm.helper_symbol(nodes[j], failed)
                         for j in helpers])
        repaired = mesh._apply_sharded(
            gf256.gf_mat_inv(pm.psi[helpers]), ("pm_rep", pm.name, failed),
            recv, mesh2, "xor").cpu().numpy()
        if not np.array_equal(repaired, nodes[failed]):
            raise AssertionError(f"{phase}: pm_mbr_6_3_5 repair differs")
        _check_device(phase, here)
        steps["geometries"] = _mesh_step(
            phase, f"lrc_10_2_2 volume of {MESH_LRC_MB} MiB encoded and "
                   f"shards 2, 11 rebuilt; pm_mbr_6_3_5 stripe of "
                   f"{MESH_WIDTH} B encoded and node {failed} repaired from "
                   f"{pm.d_helpers} helper symbols; all equal to the numpy "
                   f"coder", t0)
        counts = {k: spec["module"].KERNEL.launches
                  for k, spec in KERNELS.items()}

        # 5. the host coders, built by this machine's g++
        t0 = time.perf_counter()
        block = data[:, :MIB]
        nat = new_coder(backend="native")
        sched = geometry.encode_schedule(geometry.rs(10, 4))
        want = cpu.encode_parity(block)
        for what, got in (("RSCodecNative", nat.encode_parity(block)),
                          ("the native XOR schedule",
                           sched.execute(block, "native")),
                          ("the numpy XOR schedule",
                           sched.execute(block, "numpy"))):
            if not np.array_equal(got, want):
                raise AssertionError(f"{phase}: {what} differs from rs_cpu")
        steps["host"] = _mesh_step(
            phase, f"RSCodecNative (simd level {rs_native.simd_level()}) "
                   f"and the XOR schedule (numpy and native) at [4,10] x 1 "
                   f"MiB equal rs_cpu", t0)
    finally:
        shutil.rmtree(vdir)
        if old_window is None:
            os.environ.pop("SWFS_EC_DISPATCH_WINDOW_MS", None)
        else:
            os.environ["SWFS_EC_DISPATCH_WINDOW_MS"] = old_window
    log(phase, f"launches: {counts}; gf_xor by R: "
               f"{dict(sorted(rs_xor.KERNEL.launches_by.items()))}; two "
               f"entries of one {card} share its SMs: no multi-GPU speed is "
               f"measured here")
    for name in ("gf_xor", "gf_bits"):
        if counts[name] <= 0:
            raise AssertionError(f"{phase}: {name} was never launched")
    return dict(launches=counts, steps=steps)


# -- store --------------------------------------------------------------------


STORE_VID = 7
STORE_VOLUME_MB = 512  # pipeline's needle mix, through the Store
STORE_SAMPLE_READS = 500


def _on_card(coder) -> None:
    """The store's default coder must be the torch codec on the card."""
    if not (isinstance(coder, RSCodecTorch) and coder.device.type == "cuda"):
        raise AssertionError(f"store: the default coder is {coder!r}, not "
                             f"RSCodecTorch on cuda")


def _read_ec_needles(ev, needles, payload) -> float:
    """Every (id, cookie, start, size) needle read back through the EC
    volume as the server's EC read does it (find_needle, read_needle_blob,
    Needle.from_bytes with the size the index holds, CRC checked),
    byte-exact against the bytes written; -> seconds taken."""
    t0 = time.perf_counter()
    for nid, cookie, start, size in needles:
        _, stored = ev.find_needle(nid)
        n = Needle.from_bytes(ev.read_needle_blob(nid), ev.version,
                              expected_size=stored)
        if n.id != nid or n.cookie != cookie or \
                n.data != payload[start:start + size]:
            raise AssertionError(f"store: needle {nid} reads back wrong")
    return time.perf_counter() - t0


def store_phase(seed: int, workdir: str, card: str, smi: str) -> dict:
    """The volume server's Store on the card: needles in, ec.encode, reads
    with 3 shards lost, rebuild, restart (see the module docstring)."""
    phase = "store"
    os.environ["SEAWEEDFS_TORCH_KERNEL"] = "xor"
    sdir = tempfile.mkdtemp(prefix=f"{phase}-", dir=workdir)
    store = None
    try:
        rng = np.random.default_rng(seed)
        payload = rng.bytes(STORE_VOLUME_MB * MIB)
        t0 = time.perf_counter()
        crc_impl = crc.implementation()  # builds the native library
        log(phase, f"crc32c implementation: {crc_impl} (ready in "
                   f"{time.perf_counter() - t0:.2f} s)")
        for spec in KERNELS.values():
            spec["module"].KERNEL.reset()
        lanes0 = _lane_counts()

        store = Store([sdir], ip="127.0.0.1", port=8080)
        _on_card(store.coder)
        v = store.add_volume(STORE_VID)
        needles = []
        start = end = 0
        t0 = time.perf_counter()
        while end < STORE_VOLUME_MB * MIB:
            size = int(rng.integers(1, 64 * 1024 + 1))
            if start + size > len(payload):
                start = 0
            nid, cookie = len(needles) + 1, int(rng.integers(1, 1 << 32))
            n = Needle.create(nid, cookie, payload[start:start + size])
            off, _, unchanged = store.write_needle(STORE_VID, n)
            if unchanged:
                raise AssertionError(f"{phase}: needle {nid} deduplicated")
            end = off + types.actual_size(n.size, v.version)
            needles.append((nid, cookie, start, size))
            start += size
        write_s = time.perf_counter() - t0
        dat_bytes = v.data_size()
        log(phase, f"{len(needles)} needles of 1-64 KiB through "
                   f"Store.write_needle: {dat_bytes} B of .dat in "
                   f"{write_s:.3f} s = {dat_bytes / write_s / 1e9:.3f} GB/s "
                   f"(one group-commit flush a write) on {card}")

        # the ec.encode handlers, in order: VolumeMarkReadonly,
        # VolumeEcShardsGenerate (+ its epilogue), VolumeEcShardsMount,
        # VolumeDelete
        geo = Geometry()
        base = v.file_name()
        v.read_only = True
        coder = store.coder_for(geo)
        if coder is not store.coder:
            raise AssertionError(f"{phase}: coder_for(rs_10_4) is not the "
                                 f"store's coder")
        e0 = time.perf_counter()
        enc = ec_files.write_ec_files(base, coder, geo)
        torch.cuda.synchronize()
        e1 = time.perf_counter()
        ec_files.write_sorted_file_from_idx(base)
        e2 = time.perf_counter()
        save_volume_info(base, {
            "version": v.version,
            "dataShards": geo.data_shards, "parityShards": geo.parity_shards,
            "largeBlock": geo.large_block, "smallBlock": geo.small_block,
            "geometry": geo.code_name,
        })
        e3 = time.perf_counter()
        enc_s = e3 - e0
        lanes1 = _lane_counts()
        hashes, oracle_s = check_shards(phase, base, geo, workdir)
        store.mount_ec_shards(STORE_VID, "", list(range(geo.total_shards)))
        store.delete_volume(STORE_VID)
        if os.path.exists(base + ".dat") or os.path.exists(base + ".idx"):
            raise AssertionError(f"{phase}: delete_volume left .dat/.idx")
        log(phase, f"ec.encode of {dat_bytes} B through Store.coder_for: "
                   f"{enc_s:.3f} s = {dat_bytes / enc_s / 1e9:.3f} GB/s end "
                   f"to end on {card} (write_ec_files {e1 - e0:.3f} s: "
                   f"{encode_detail(enc)}; write_sorted_file_from_idx "
                   f"{e2 - e1:.3f} s; save_volume_info {e3 - e2:.3f} s); "
                   f"14 shard sha256s match the numpy cpu coder "
                   f"({oracle_s:.1f} s); mounted, plain volume deleted")

        for i in REBUILD_LOST:
            os.remove(geo.shard_file_name(base, i))
        store.mount_ec_shards(STORE_VID, "", [])
        ev = store.find_ec_volume(STORE_VID)
        if sorted(ev.shard_files) != sorted(
                set(range(geo.total_shards)) - set(REBUILD_LOST)):
            raise AssertionError(f"{phase}: remount sees {sorted(ev.shard_files)}")
        extents = []
        for needle in needles:
            off, size = ev.find_needle(needle[0])
            extents.append((needle, off, types.actual_size(size, ev.version)))
        degraded, healthy = split_by_lost(geo, ev.dat_size_estimate, extents,
                                          REBUILD_LOST)
        healthy_s = _read_ec_needles(ev, healthy, payload)
        degraded_s = _read_ec_needles(ev, degraded, payload)
        lanes2 = _lane_counts()
        log(phase, f"{len(needles)} needles read through "
                   f"Store.find_ec_volume with shards {list(REBUILD_LOST)} "
                   f"lost, byte-exact, CRC verified: {len(healthy)} from "
                   f"live shards in {healthy_s:.3f} s "
                   f"({healthy_s / max(len(healthy), 1) * 1e3:.3f} ms "
                   f"each), {len(degraded)} degraded in {degraded_s:.3f} s "
                   f"({degraded_s / max(len(degraded), 1) * 1e3:.3f} ms "
                   f"each), one reader")

        rebuild_gbps = rebuild_checked(phase, base, geo, coder, hashes, card,
                                       then=rebuild_ecx_file)
        lanes3 = _lane_counts()
        store.mount_ec_shards(STORE_VID, "", list(REBUILD_LOST))
        log(phase, "rebuilt shards and .ecx remounted")

        store.close()
        store = None
        if os.path.exists(recovery.marker_path(sdir)):
            raise AssertionError(f"{phase}: close() left the dirty marker")
        t0 = time.perf_counter()
        store = Store([sdir], ip="127.0.0.1", port=8080)
        _on_card(store.coder)
        if store.recovery_report.unclean or store.find_volume(STORE_VID):
            raise AssertionError(f"{phase}: restart saw an unclean store or "
                                 f"the deleted plain volume")
        ev = store.find_ec_volume(STORE_VID)
        if ev is None or len(ev.shard_files) != geo.total_shards:
            raise AssertionError(f"{phase}: restart did not reload the EC "
                                 f"volume")
        pick = np.random.default_rng(seed + 1).choice(
            len(needles), size=min(len(needles), STORE_SAMPLE_READS),
            replace=False)
        _read_ec_needles(ev, [needles[i] for i in sorted(pick)], payload)
        log(phase, f"restart: a new Store reloaded EC volume {STORE_VID} "
                   f"(14 shards) in {time.perf_counter() - t0:.3f} s and "
                   f"read {len(pick)} needles back byte-exact")
        store.close()
        store = None

        counts = {k: spec["module"].KERNEL.launches
                  for k, spec in KERNELS.items()}
        log_lanes(phase, (("encode", "encode", lanes0, lanes1),
                          ("degraded reads", "reconstruct", lanes1, lanes2),
                          ("rebuild", "reconstruct", lanes2, lanes3)))
        log(phase, f"launches: {counts}; gf_xor by R: "
                   f"{dict(sorted(rs_xor.KERNEL.launches_by.items()))}; "
                   f"crc32c {crc_impl}; nvidia-smi: {smi}")
        if counts["gf_xor"] <= 0:
            raise AssertionError(f"{phase}: gf_xor was never launched")
        return dict(launches=counts["gf_xor"],
                    write_gbps=dat_bytes / write_s / 1e9,
                    encode_gbps=dat_bytes / enc_s / 1e9,
                    rebuild_gbps=rebuild_gbps)
    finally:
        if store is not None:
            store.close()
        shutil.rmtree(sdir)
        os.environ.pop("SEAWEEDFS_TORCH_KERNEL", None)


# -- server -------------------------------------------------------------------


SERVER_VID = 9
# the store phase's needle mix over HTTP, at a quarter of the pipeline's
# size: at 1 GiB the script came within 31 s of its 1200 s limit on a slow
# host, and the later phases' time came out of this phase's depth
SERVER_VOLUME_MB = 256
SERVER_CLIENTS = 8  # writer threads, then reader threads
SERVER_START_S = 120  # process start until /status answers
SERVER_EC_TIMEOUT_S = 600  # the first EC RPC may build K1 (60-104 s of nvcc)
SCRUB_FLIP_SHARD = 3
HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port_pair() -> int:
    """A free HTTP port whose gRPC twin (+10000) is free too."""
    for _ in range(200):
        with socket.socket() as s:
            s.bind(("", 0))
            port = s.getsockname()[1]
        if port + 10000 > 65535:
            continue
        with socket.socket() as s2:
            try:
                s2.bind(("", port + 10000))
            except OSError:
                continue
        return port
    raise RuntimeError("no free port pair")


# 307s followed by _request: a volume server's or a filer's C++ plane
# hands what it does not serve (status pages, EC volumes, replicated
# writes, ranges it does not take) to its Python listener
REDIRECTS = collections.Counter()
_REDIRECTS_MU = threading.Lock()
# each thread's keep-alive connections to the Locations it was sent to,
# as a client's connection pool holds them
_HOPS = threading.local()


def _hop(host: str, port: int, timeout: float) -> http.client.HTTPConnection:
    conns = getattr(_HOPS, "conns", None)
    if conns is None:
        conns = _HOPS.conns = {}
    conn = conns.get((host, port))
    if conn is None:
        conn = conns[(host, port)] = http.client.HTTPConnection(
            host, port, timeout=timeout)
    return conn


def _request(conn, method: str, path: str, body: bytes | None = None,
             headers: dict | None = None) -> tuple[int, bytes, bool]:
    """One request on a keep-alive connection, following one 307 to its
    Location as a client does (the body sent again, on the thread's
    keep-alive connection to that address) -> (status, body, whether it
    was redirected)."""
    conn.request(method, path, body=body, headers=headers or {})
    r = conn.getresponse()
    data = r.read()
    if r.status != 307:
        return r.status, data, False
    loc = urllib.parse.urlsplit(r.getheader("Location"))
    with _REDIRECTS_MU:
        REDIRECTS[method] += 1
    target = loc.path + (f"?{loc.query}" if loc.query else "")
    for attempt in (0, 1):
        hop = _hop(loc.hostname, loc.port, conn.timeout)
        try:
            hop.request(method, target, body=body, headers=headers or {})
            r = hop.getresponse()
            return r.status, r.read(), True
        except (ConnectionError, http.client.HTTPException):
            # a kept connection the server closed (or a server that
            # restarted on the address): one fresh connection
            hop.close()
            del _HOPS.conns[(loc.hostname, loc.port)]
            if attempt:
                raise


def _http(conn, method: str, path: str, body: bytes | None = None):
    """One request on a keep-alive connection (one 307 followed) ->
    (status, body)."""
    return _request(conn, method, path, body)[:2]


def _plane(port: int) -> tuple[bool, int, int]:
    """A volume server's (NativeDataPlane, NativeRequests, NativeSendfile)
    from its /status."""
    st = _status(port)
    return st["NativeDataPlane"], st["NativeRequests"], st["NativeSendfile"]


def _fid(nid: int, cookie: int, vid: int = SERVER_VID) -> str:
    return f"{vid},{format_needle_id_cookie(nid, cookie)}"


def _clients(port: int, work, items, clients: int = SERVER_CLIENTS) -> list:
    """work(conn, item) for every item, `clients` threads with one
    keep-alive connection each, items dealt round-robin; -> the results
    in order. The first error raises."""
    out = [None] * len(items)

    def run(t):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            for i in range(t, len(items), clients):
                out[i] = work(conn, items[i])
        finally:
            conn.close()

    _all_at_once(run, list(range(clients)))
    return out


def _get_all(phase: str, port: int, needles, payload,
             vid: int = SERVER_VID, clients: int = SERVER_CLIENTS
             ) -> list[float]:
    """GET every (id, cookie, start, size) needle of volume `vid`,
    byte-exact against the bytes written; -> the seconds each GET
    took."""
    def get(conn, needle):
        nid, cookie, start, size = needle
        t0 = time.perf_counter()
        status, body = _http(conn, "GET", "/" + _fid(nid, cookie, vid))
        dt = time.perf_counter() - t0
        if status != 200 or body != payload[start:start + size]:
            raise AssertionError(f"{phase}: GET of needle {nid}: {status}, "
                                 f"{len(body)} B, not the bytes written")
        return dt

    return _clients(port, get, needles, clients)


def _ms(xs: list[float]) -> str:
    if not xs:
        return "none"
    q = statistics.quantiles(xs, n=100) if len(xs) > 1 else xs * 99
    return (f"mean {statistics.fmean(xs) * 1e3:.3f} ms, p50 "
            f"{q[49] * 1e3:.3f} ms, p99 {q[98] * 1e3:.3f} ms")


def _status(port: int) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        status, body = _http(conn, "GET", "/status")
    finally:
        conn.close()
    if status != 200:
        raise AssertionError(f"server: /status answered {status}")
    return json.loads(body)


def _json_get(port: int, path: str) -> dict:
    """GET `path` of a server's HTTP port (one 307 followed) -> its
    JSON."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        status, body = _http(conn, "GET", path)
    finally:
        conn.close()
    if status != 200:
        raise ValueError(f"GET {path} on :{port} answered {status}")
    return json.loads(body)


def _metrics(port: int) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        status, body = _http(conn, "GET", "/metrics")
    finally:
        conn.close()
    if status != 200:
        raise AssertionError(f"server: /metrics answered {status}")
    return body.decode()


def _kernel_launches(port: int) -> dict:
    """{(kernel, rows or ""): launches} from the server's /metrics."""
    out = {}
    for line in _metrics(port).splitlines():
        m = re.match(r'SeaweedFS_ec_kernel_launches\{kernel="(\w+)"'
                     r'(?:,rows="(\d+)")?\} (\S+)$', line)
        if m:
            out[(m.group(1), m.group(2) or "")] = int(float(m.group(3)))
    return out


def _stream_counters(port: int) -> dict:
    """{"name{labels}": value} of the server's SeaweedFS_ec_stream_*
    counters and gauges, from its /metrics."""
    out = {}
    for line in _metrics(port).splitlines():
        m = re.match(r"SeaweedFS_ec_stream_(\w+?(?:\{[^}]*\})?) (\S+)$", line)
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


# the gauges among them: read as they are after a step, not as a change
STREAM_GAUGES = ("overlap_ratio", "inflight_bytes")


def _stream_step(before: dict, after: dict) -> dict:
    """One step's stream counters: each counter's change, each gauge's
    value after; only what is not 0."""
    out = {}
    for key in sorted(after):
        v = after[key] if key.startswith(STREAM_GAUGES) else \
            after[key] - before.get(key, 0.0)
        if v:
            out[key] = int(v) if v == int(v) else round(v, 4)
    return out


def _server_counts(port: int) -> dict:
    """The server's own counters: K1 launches by R (/metrics) and the
    dispatch lanes' slabs and batches (/status EcDispatch)."""
    st = _status(port)["EcDispatch"]
    by_r = {int(r): n for (k, r), n in _kernel_launches(port).items()
            if k == "gf_xor" and r}
    return dict(k1=by_r, dispatch=st,
                lanes={lane: (st[lane]["slabs"], st[lane]["batches"])
                       for lane in ("encode", "reconstruct")})


def _server_step(phase: str, what: str, a: dict, b: dict) -> dict:
    """Log and return what one step launched: K1 by R, lanes' slabs and
    batches (after minus before)."""
    k1 = {r: b["k1"].get(r, 0) - a["k1"].get(r, 0)
          for r in sorted(set(a["k1"]) | set(b["k1"]))}
    k1 = {r: n for r, n in k1.items() if n}
    lanes = {lane: (b["lanes"][lane][0] - a["lanes"][lane][0],
                    b["lanes"][lane][1] - a["lanes"][lane][1])
             for lane in b["lanes"]}
    log(phase, f"{what}: K1 launches by R {k1}; encode lane "
               f"{lanes['encode'][0]} slabs in {lanes['encode'][1]} "
               f"batches, reconstruct lane {lanes['reconstruct'][0]} slabs "
               f"in {lanes['reconstruct'][1]} batches")
    return dict(k1=k1, lanes=lanes)


def server_phase(seed: int, workdir: str, card: str, smi: str) -> dict:
    """`python3 -m seaweedfs_tpu_torch volume` on the card, driven over
    HTTP and gRPC (see the module docstring)."""
    phase = "server"
    sdir = tempfile.mkdtemp(prefix=f"{phase}-", dir=workdir)
    vdir = os.path.join(sdir, "data")
    os.mkdir(vdir)
    port, nobody = _free_port_pair(), _free_port_pair()
    env = {k: v for k, v in os.environ.items()
           if k not in ("SEAWEEDFS_TORCH_KERNEL", "SEAWEEDFS_TORCH_CODER")}
    env["SWFS_SCRUB_MAX_MBPS"] = "0"  # unpaced scrub
    cached = _build.library_path("gf_xor.cu").exists()
    log_path = os.path.join(sdir, "server.log")
    log_f = open(log_path, "wb")
    proc = None
    try:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "volume",
             "-dir", vdir, "-port", str(port),
             "-mserver", f"localhost:{nobody}"],
            cwd=HERE, env=env, stdout=log_f, stderr=subprocess.STDOUT)
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"{phase}: the server exited with "
                                     f"{proc.returncode} at start")
            try:
                _status(port)
                break
            except OSError:
                if time.perf_counter() - t0 > SERVER_START_S:
                    raise
                time.sleep(0.2)
        start_s = time.perf_counter() - t0
        rpc.reset_channels()  # no channel dialled before the listener
        stub = rpc.volume_stub(rpc.grpc_address(f"localhost:{port}"))
        log(phase, f"python3 -m seaweedfs_tpu_torch volume (default coder, "
                   f"master localhost:{nobody} unreachable) answered "
                   f"/status in {start_s:.2f} s; K1's library was "
                   f"{'already built' if cached else 'not built yet'}")
        stub.AllocateVolume(vs.AllocateVolumeRequest(
            volume_id=SERVER_VID, replication="000"), timeout=60)

        rng = np.random.default_rng(seed)
        payload = rng.bytes(SERVER_VOLUME_MB * MIB)
        needles = []
        start = total = 0
        while total < SERVER_VOLUME_MB * MIB:
            size = int(rng.integers(1, 64 * 1024 + 1))
            if start + size > len(payload):
                start = 0
            needles.append((len(needles) + 1, int(rng.integers(1, 1 << 32)),
                            start, size))
            start += size
            total += size

        def post(conn, needle):
            nid, cookie, begin, size = needle
            status, body = _http(conn, "POST", "/" + _fid(nid, cookie),
                                 payload[begin:begin + size])
            if status != 201:
                raise AssertionError(f"{phase}: POST of needle {nid}: "
                                     f"{status} {body[:200]!r}")

        t0 = time.perf_counter()
        _clients(port, post, needles)
        write_s = time.perf_counter() - t0
        dat_bytes = stub.VolumeStatus(vs.VolumeStatusRequest(
            volume_id=SERVER_VID), timeout=60).volume_size
        log(phase, f"{len(needles)} needles ({total} B of 1-64 KiB) POSTed "
                   f"by {SERVER_CLIENTS} clients: {dat_bytes} B of .dat in "
                   f"{write_s:.3f} s = {total / write_s / 1e9:.3f} GB/s of "
                   f"needle bytes on {card}")

        # an eighth of the needles GET from the plain volume: the C++
        # plane's own reads (sendfile from 4,096 B), before the encode
        # sends every GET to the Python listener
        plain_ms = _get_all(phase, port, needles[::8], payload)
        log(phase, f"{len(needles[::8])} needles GET byte-exact from the "
                   f"plain volume by {SERVER_CLIENTS} readers "
                   f"({_ms(plain_ms)})")

        # ec.encode: read-only, generate, unmount the plain volume, mount
        # the 14 shards
        geo = Geometry()
        base = os.path.join(vdir, str(SERVER_VID))
        c0 = _server_counts(port)
        stub.VolumeMarkReadonly(vs.VolumeMarkReadonlyRequest(
            volume_id=SERVER_VID), timeout=60)
        t0 = time.perf_counter()
        stub.VolumeEcShardsGenerate(ec_geometry_pb2.EcGenerateRequest(
            volume_id=SERVER_VID), timeout=SERVER_EC_TIMEOUT_S)
        enc_s = time.perf_counter() - t0
        stub.VolumeUnmount(vs.VolumeUnmountRequest(volume_id=SERVER_VID),
                           timeout=60)
        stub.VolumeEcShardsMount(vs.VolumeEcShardsMountRequest(
            volume_id=SERVER_VID, shard_ids=list(range(geo.total_shards))),
            timeout=60)
        hashes, oracle_s = check_shards(phase, base, geo, workdir)
        c1 = _server_counts(port)
        log(phase, f"VolumeEcShardsGenerate of {dat_bytes} B: {enc_s:.3f} s "
                   f"= {dat_bytes / enc_s / 1e9:.3f} GB/s on {card}; 14 "
                   f"shard sha256s match the numpy cpu coder "
                   f"({oracle_s:.1f} s); 14 shards mounted")

        # 3 shards lost: every needle by GET, live and degraded apart
        stub.VolumeEcShardsUnmount(vs.VolumeEcShardsUnmountRequest(
            volume_id=SERVER_VID, shard_ids=list(REBUILD_LOST)), timeout=60)
        stub.VolumeEcShardsDelete(vs.VolumeEcShardsDeleteRequest(
            volume_id=SERVER_VID, shard_ids=list(REBUILD_LOST)), timeout=60)
        survivors = [i for i in range(geo.total_shards)
                     if i not in REBUILD_LOST]
        stub.VolumeEcShardsMount(vs.VolumeEcShardsMountRequest(
            volume_id=SERVER_VID, shard_ids=survivors), timeout=60)
        ev = EcVolume(base, new_coder(backend="cpu"), geo=geo)
        try:
            extents = []
            for needle in needles:
                off, size = ev.find_needle(needle[0])
                extents.append((needle, off,
                                types.actual_size(size, ev.version)))
            degraded, live = split_by_lost(geo, ev.dat_size_estimate,
                                           extents, REBUILD_LOST)
        finally:
            ev.close()
        c2 = _server_counts(port)
        live_ms = _get_all(phase, port, live, payload)
        degraded_ms = _get_all(phase, port, degraded, payload)
        c3 = _server_counts(port)
        log(phase, f"shards {list(REBUILD_LOST)} unmounted and deleted, "
                   f"{len(survivors)} remounted; every needle GET "
                   f"byte-exact by {SERVER_CLIENTS} readers: {len(live)} "
                   f"live ({_ms(live_ms)}), {len(degraded)} degraded "
                   f"({_ms(degraded_ms)})")

        t0 = time.perf_counter()
        reb = stub.VolumeEcShardsRebuild(ec_geometry_pb2.EcRebuildRequest(
            volume_id=SERVER_VID), timeout=SERVER_EC_TIMEOUT_S)
        reb_s = time.perf_counter() - t0
        if tuple(reb.rebuilt_shard_ids) != REBUILD_LOST:
            raise AssertionError(f"{phase}: rebuilt "
                                 f"{list(reb.rebuilt_shard_ids)}")
        stub.VolumeEcShardsMount(vs.VolumeEcShardsMountRequest(
            volume_id=SERVER_VID, shard_ids=list(REBUILD_LOST)), timeout=60)
        if shard_hashes(base, geo) != hashes:
            raise AssertionError(f"{phase}: rebuilt shards differ")
        c4 = _server_counts(port)
        rebuild_gbps = reb.survivor_bytes_read / reb_s / 1e9
        log(phase, f"VolumeEcShardsRebuild of {list(REBUILD_LOST)}: "
                   f"{reb_s:.3f} s = {rebuild_gbps:.3f} GB/s of survivors "
                   f"read ({reb.survivor_bytes_read} B) on {card}; "
                   f"sha-identical, remounted")

        # one byte flipped in .ec03 on disk: the scrub finds and repairs it
        path = geo.shard_file_name(base, SCRUB_FLIP_SHARD)
        flip_at = os.path.getsize(path) // 2 + 12345
        with open(path, "r+b") as f:
            f.seek(flip_at)
            b = f.read(1)
            f.seek(flip_at)
            f.write(bytes([b[0] ^ 0x5A]))
        t0 = time.perf_counter()
        first = stub.VolumeScrub(scrub_pb2.VolumeScrubRequest(
            volume_id=SERVER_VID, full=True, repair=True),
            timeout=SERVER_EC_TIMEOUT_S)
        scrub_s = time.perf_counter() - t0
        found = [(f.kind, f.state, f.shard_id) for f in first.findings]
        if found != [("ec_parity", "repaired", SCRUB_FLIP_SHARD)]:
            raise AssertionError(f"{phase}: scrub found {found}")
        second = stub.VolumeScrub(scrub_pb2.VolumeScrubRequest(
            volume_id=SERVER_VID, full=True, repair=True),
            timeout=SERVER_EC_TIMEOUT_S)
        if list(second.findings):
            raise AssertionError(f"{phase}: a second scrub found "
                                 f"{list(second.findings)}")
        if shard_hashes(base, geo) != hashes:
            raise AssertionError(f"{phase}: repaired shards differ")
        c5 = _server_counts(port)
        again = _get_all(phase, port, needles, payload)
        log(phase, f"byte {flip_at} of .ec{SCRUB_FLIP_SHARD:02d} flipped: "
                   f"VolumeScrub (full, repair) found one ec_parity "
                   f"finding on shard {SCRUB_FLIP_SHARD}, repaired, in "
                   f"{scrub_s:.3f} s ({first.bytes_verified} B verified); "
                   f"a second pass found none; shards sha-identical; every "
                   f"needle GET byte-exact again ({_ms(again)})")

        # each step's launches, from the server's own counters: every
        # batch of the lanes it used ran K1 on the card. A degraded GET
        # reconstructs every row outside its 10 planned survivors, as the
        # reference server does, so K1 runs there at R = 4.
        steps = [_server_step(phase, what, a, b) for what, a, b in (
            ("VolumeEcShardsGenerate", c0, c1), ("GETs", c2, c3),
            ("VolumeEcShardsRebuild", c3, c4), ("VolumeScrub x2", c4, c5))]
        st = c5["dispatch"]
        log(phase, f"/status EcDispatch: encode {st['encode']}, reconstruct "
                   f"{st['reconstruct']}, reasons {st['reasons']}, perChip "
                   f"{st['perChip']}, reconCache {st['reconCache']}")
        if set(st["reasons"]) != {"singleDevice"}:
            raise AssertionError(f"{phase}: EC work ran off the card's "
                                 f"lanes: {st['reasons']}")
        enc, gets, reb, scrub = steps
        for what, step, lane in (("encode", enc, "encode"),
                                 ("degraded GETs", gets, "reconstruct"),
                                 ("rebuild", reb, "reconstruct"),
                                 ("scrub", scrub, "encode")):
            launched = sum(step["k1"].values())
            if not launched or launched < step["lanes"][lane][1]:
                raise AssertionError(f"{phase}: {what} launched K1 {launched}"
                                     f" times for {step['lanes'][lane][1]} "
                                     f"{lane} batches")
        if not (enc["k1"].get(4) and reb["k1"].get(3)):
            raise AssertionError(f"{phase}: K1 did not encode at R = 4 and "
                                 f"rebuild at R = 3: {steps}")
        by_r = c5["k1"]
        # the public port is the C++ plane, as the reference's default
        # (`-nativeDataPlane auto` wherever g++ builds it): needle POSTs
        # and live GETs (sendfile from 4,096 B), everything else 307ed
        native, requests_n, sendfile_n = _plane(port)
        if not (native and requests_n > 0 and sendfile_n > 0):
            raise AssertionError(f"{phase}: /status NativeDataPlane "
                                 f"{native}, NativeRequests {requests_n}, "
                                 f"NativeSendfile {sendfile_n}")
        log(phase, f"/status: NativeDataPlane {native}, NativeRequests "
                   f"{requests_n}, NativeSendfile {sendfile_n}; 307s this "
                   f"script followed so far {dict(REDIRECTS)}")

        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        if rc != 0:
            raise AssertionError(f"{phase}: the server exited {rc} on "
                                 f"SIGTERM")
        if os.path.exists(recovery.marker_path(vdir)):
            raise AssertionError(f"{phase}: the dirty marker was not lifted")
        proc = None
        gets = live_ms + degraded_ms
        log(phase, f"SIGTERM: exit 0, dirty marker lifted. write "
                   f"{total / write_s / 1e9:.3f} GB/s, encode "
                   f"{dat_bytes / enc_s / 1e9:.3f} GB/s, rebuild "
                   f"{rebuild_gbps:.3f} GB/s, GET of the plain volume "
                   f"{statistics.fmean(plain_ms) * 1e3:.3f} ms, GET live "
                   f"{statistics.fmean(live_ms) * 1e3:.3f} ms, degraded "
                   f"{statistics.fmean(degraded_ms) * 1e3:.3f} ms "
                   f"({len(gets)} GETs); gf_xor by R {dict(sorted(by_r.items()))}; "
                   f"nvidia-smi: {smi}")
        return dict(launches=sum(by_r.values()))
    except BaseException:
        log_f.flush()
        with open(log_path, "rb") as f:
            tail = f.read()[-4000:].decode(errors="replace")
        log(phase, f"server log tail:\n{tail}")
        raise
    finally:
        if proc is not None:
            proc.kill()
            proc.wait()
        log_f.close()
        rpc.reset_channels()
        shutil.rmtree(sdir)


# -- cluster --------------------------------------------------------------------


CLUSTER_VOLUME_MB = 128  # needle bytes: the .dat stays under the limit
CLUSTER_LIMIT_MB = 1024  # the master's -volumeSizeLimitMB
CLUSTER_SMALL_MB = 128  # config #5's collection
CLUSTER_MULTI = 4  # config #4: volumes streamed at once (-parallelEncode)
CLUSTER_MULTI_MB = 32  # needle bytes of each
CLUSTER_MULTI_FULL = 2  # ec.encode -fullPercent that selects them
CLUSTER_RACKS = ("r0", "r0", "r1", "r1")
CLUSTER_DELETED = 0.10  # the share of needles deleted before the vacuum
CLUSTER_CALL_S = 1200  # the longest a shell command may take
SMALL_GEO = Geometry(data_shards=6, parity_shards=3)


class _Fleet:
    """The cluster phase's processes: `python3 -m seaweedfs_tpu_torch`
    master and volume servers, each with its own log, and shells."""

    def __init__(self, phase: str, root: str):
        self.phase = phase
        self.root = root
        self.env = {k: v for k, v in os.environ.items()
                    if k not in ("SEAWEEDFS_TORCH_KERNEL",
                                 "SEAWEEDFS_TORCH_CODER")}
        self.env["SWFS_SCRUB_MAX_MBPS"] = "0"  # unpaced scrub
        self.env["PYTHONPATH"] = os.pathsep.join(
            [HERE] + [p for p in self.env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        self.procs: dict[str, tuple] = {}  # name -> (proc, log, port, dir)
        self.rack_of: dict[str, str] = {}  # volume server address -> rack
        self.master_port = _free_port_pair()
        self.master = f"127.0.0.1:{self.master_port}"
        # a Raft group's masters (spawn_raft_masters): their ports and
        # the arguments each was started with
        self.master_ports: list[int] = []
        self.master_args: dict[str, list[str]] = {}
        self.k1_gone: dict[int, int] = {}  # K1 by R of killed servers
        # _plane of killed servers, read just before they were killed
        self.planes_gone: dict[str, tuple] = {}

    def _spawn(self, name: str, args: list[str], port: int, d: str,
               env: dict | None = None, modules: str = "",
               cwd: str = HERE):
        """`modules`: a file the process writes its sys.modules to as it
        exits; `cwd`: its working directory (the port is found from any,
        through PYTHONPATH)."""
        log_f = open(os.path.join(self.root, f"{name}.log"), "wb")
        cmd = ([sys.executable, "-c", _MODULES_WRAPPER, modules] if modules
               else [sys.executable, "-m", "seaweedfs_tpu_torch"])
        proc = subprocess.Popen(
            cmd + args, cwd=cwd, env={**self.env, **(env or {})},
            stdout=log_f, stderr=subprocess.STDOUT)
        self.procs[name] = (proc, log_f, port, d)

    @staticmethod
    def is_volume(name: str) -> bool:
        return not name.startswith(("master", "filer", "s3") + GW_NAMES)

    def spawn_master(self) -> None:
        self._spawn("master", ["master", "-ip", "127.0.0.1", "-port",
                               str(self.master_port), "-volumeSizeLimitMB",
                               str(CLUSTER_LIMIT_MB), "-defaultReplication",
                               "001"], self.master_port, "")

    def spawn_raft_masters(self, n: int) -> None:
        """`n` masters of one Raft group (-peers, each on its own -mdir),
        named master, master1, ...; volume servers and shells are given
        every one of them, the leader first once `lead` knows it."""
        ports = [self.master_port]
        while len(ports) < n:
            p = _free_port_pair()
            if p not in ports + self.ports():
                ports.append(p)
        self.master_ports = ports
        self.master = ",".join(f"127.0.0.1:{p}" for p in ports)
        for i, port in enumerate(ports):
            name = f"master{i}" if i else "master"
            mdir = os.path.join(self.root, f"{name}-mdir")
            self.master_args[name] = [
                "master", "-ip", "127.0.0.1", "-port", str(port),
                "-volumeSizeLimitMB", str(CLUSTER_LIMIT_MB),
                "-defaultReplication", "001", "-peers", self.master,
                "-mdir", mdir]
            self._spawn(name, self.master_args[name], port, mdir)

    def leader(self) -> str:
        """The address of the master that leads (the only one without a
        Raft group)."""
        return f"127.0.0.1:{self.master_port}"

    def lead(self, timeout: float = 120) -> str:
        """Wait until one running master of the Raft group leads; put it
        first in `master` and make it `master_port`; -> its address."""
        t0 = time.perf_counter()
        while True:
            for name, (proc, _, port, _) in self.procs.items():
                if not name.startswith("master") or proc.poll() is not None:
                    continue
                try:
                    st = _json_get(port, "/cluster/raft/status")
                except (OSError, ValueError):
                    continue
                if st.get("role") == "leader":
                    self.master_port = port
                    self.master = ",".join(
                        f"127.0.0.1:{p}" for p in
                        [port] + [p for p in self.master_ports if p != port])
                    return f"127.0.0.1:{port}"
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"{self.phase}: no master leads")
            time.sleep(0.1)

    def spawn_volume(self, name: str, rack: str,
                     env: dict | None = None, args=()) -> None:
        """A volume server; `env` adds to the fleet's environment for
        this process alone, `args` to its command line."""
        port = _free_port_pair()
        while port == self.master_port or port in self.ports():
            port = _free_port_pair()
        d = os.path.join(self.root, name)
        os.mkdir(d)
        self.rack_of[f"127.0.0.1:{port}"] = rack
        self._spawn(name, ["volume", "-dir", d, "-ip", "127.0.0.1",
                           "-port", str(port), "-mserver", self.master,
                           "-rack", rack, *args], port, d, env)

    def ports(self) -> list[int]:
        return [p for _, _, p, _ in self.procs.values()]

    @staticmethod
    def port_of(address: str) -> int:
        return int(address.rsplit(":", 1)[1])

    def stream_counters(self) -> dict[str, dict]:
        """{address: _stream_counters} of every running volume server."""
        return {a: _stream_counters(self.port_of(a)) for a in self.volumes()}

    def crc_kernels(self) -> dict[str, str]:
        """The CRC-32C kernel each running volume server reports; fails
        unless every one is compiled (the streamed encode CRCs every
        slab once at the source and twice at its destination)."""
        got = {a: _status(self.port_of(a))["EcStream"]["crc32c"]
               for a in self.volumes()}
        slow = {a: k for a, k in got.items()
                if k not in ("native", "google_crc32c")}
        if slow:
            raise AssertionError(f"{self.phase}: CRC-32C runs in {slow}")
        return got

    def spawn_filer(self, name: str, collection: str, d: str,
                    env: dict | None = None) -> int:
        """A filer on its store directory `d` (kept across restarts under
        the same name prefix); -> its port."""
        port = _free_port_pair()
        while port == self.master_port or port in self.ports():
            port = _free_port_pair()
        self._spawn(name, ["filer", "-ip", "127.0.0.1", "-port", str(port),
                           "-master", self.master, "-dir", d,
                           "-collection", collection], port, d, env)
        return port

    def volumes(self) -> dict[str, tuple]:
        """{address: (name, dir)} of the running volume servers."""
        return {f"127.0.0.1:{p}": (n, d)
                for n, (proc, _, p, d) in self.procs.items()
                if self.is_volume(n) and proc.poll() is None}

    def wait_up(self, names, timeout: float = SERVER_START_S) -> float:
        """Wait until each process answers /status and the master lists
        every volume server; -> seconds."""
        t0 = time.perf_counter()
        for name in names:
            proc, _, port, _ = self.procs[name]
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"{self.phase}: {name} exited with "
                                         f"{proc.returncode} at start")
                try:
                    _status(port)
                    break
                except OSError:
                    if time.perf_counter() - t0 > timeout:
                        raise
                    time.sleep(0.2)
        if self.master_ports:
            self.lead(timeout)
        self.wait_nodes(set(self.volumes()), timeout)
        return time.perf_counter() - t0

    def nodes(self) -> set[str]:
        return set(_status(self.master_port)["Topology"]["DataNodes"])

    def wait_nodes(self, want: set[str], timeout: float = 120) -> None:
        t0 = time.perf_counter()
        while self.nodes() != want:
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"{self.phase}: the master lists "
                                     f"{sorted(self.nodes())}, not "
                                     f"{sorted(want)}")
            time.sleep(0.2)

    def shell(self, *lines: str, filer: str = "",
              cwd: str = HERE) -> tuple[str, float]:
        """Commands through `python3 -m seaweedfs_tpu_torch shell` on
        stdin (with `-filer` when given, from `cwd`); -> (output,
        seconds). A command that fails fails the run."""
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "shell",
             "-master", self.master] + (["-filer", filer] if filer else []),
            cwd=cwd, env=self.env,
            input="\n".join(lines) + "\n", capture_output=True, text=True,
            timeout=CLUSTER_CALL_S)
        wall = time.perf_counter() - t0
        out = r.stdout
        if r.returncode != 0 or "error:" in out or "unknown command" in out:
            raise AssertionError(f"{self.phase}: shell {list(lines)} "
                                 f"exited {r.returncode}:\n{out}\n"
                                 f"{r.stderr[-4000:]}")
        return out, wall

    def k1(self) -> dict[int, int]:
        """K1 launches by R summed over every volume server, killed ones
        included (read just before they were killed)."""
        out = dict(self.k1_gone)
        for name, (proc, _, port, _) in self.procs.items():
            if not self.is_volume(name) or proc.poll() is not None:
                continue
            for (k, r), n in _kernel_launches(port).items():
                if k == "gf_xor" and r:
                    out[int(r)] = out.get(int(r), 0) + n
        return out

    def planes(self) -> dict[str, tuple]:
        """{address: _plane} of every volume server, killed ones included;
        fails unless each serves from the C++ plane and took requests."""
        got = dict(self.planes_gone)
        got.update({a: _plane(self.port_of(a)) for a in self.volumes()})
        off = {a: p for a, p in got.items() if not (p[0] and p[1] > 0)}
        if off:
            raise AssertionError(f"{self.phase}: volume servers off the C++ "
                                 f"plane or without requests: {off}")
        return got

    def kill(self, address: str) -> None:
        name, _ = self.volumes()[address]
        proc, _, port, _ = self.procs[name]
        self.planes_gone[address] = _plane(port)
        for (k, r), n in _kernel_launches(port).items():
            if k == "gf_xor" and r:
                self.k1_gone[int(r)] = self.k1_gone.get(int(r), 0) + n
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        self.wait_nodes(set(self.volumes()))

    def terminate(self) -> dict[str, int]:
        """SIGTERM to every process still running -> their exit codes."""
        live = {n: p for n, (p, _, _, _) in self.procs.items()
                if p.poll() is None}
        for p in live.values():
            p.send_signal(signal.SIGTERM)
        return {n: p.wait(timeout=120) for n, p in live.items()}

    def close(self) -> None:
        for proc, log_f, _, _ in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log_f.close()

    def log_tails(self) -> str:
        out = []
        for name in self.procs:
            with open(os.path.join(self.root, f"{name}.log"), "rb") as f:
                tail = f.read()[-1500:].decode(errors="replace")
            out.append(f"--- {name}\n{tail}")
        return "\n".join(out)


def _k1_step(before: dict, after: dict) -> dict:
    return {r: after.get(r, 0) - before.get(r, 0)
            for r in sorted(set(before) | set(after))
            if after.get(r, 0) - before.get(r, 0)}


def _seeded_needles(rng, total_mb: int, payload: bytes) -> list[tuple]:
    """(start, size) slices of `payload` of 1-64 KiB, `total_mb` MiB."""
    out = []
    start = total = 0
    while total < total_mb * MIB:
        size = int(rng.integers(1, 64 * 1024 + 1))
        if start + size > len(payload):
            start = 0
        out.append((start, size))
        start += size
        total += size
    return out


def _in_threads(work, items) -> list:
    """work(item) for every item by SERVER_CLIENTS threads, items dealt
    round-robin; -> the results in order. The first error raises."""
    out = [None] * len(items)

    def run(t):
        for i in range(t, len(items), SERVER_CLIENTS):
            out[i] = work(items[i])

    _all_at_once(run, list(range(SERVER_CLIENTS)))
    return out


def _submit_all(phase: str, master: str, collection: str, needles,
                payload: bytes, replication: str = "001"
                ) -> tuple[list[str], float]:
    """Every needle through operation.submit by 8 clients; -> (fids,
    seconds)."""
    from seaweedfs_tpu_torch.operation import submit

    def one(needle):
        start, size = needle
        r = submit(master, payload[start:start + size],
                   collection=collection, replication=replication)
        if "error" in r:
            raise AssertionError(f"{phase}: submit: {r['error']}")
        return r["fid"]

    t0 = time.perf_counter()
    fids = _in_threads(one, needles)
    return fids, time.perf_counter() - t0


def _get_each(phase: str, urls_of, items, payload: bytes) -> list[float]:
    """GET each (fid, start, size) item at urls_of(fid)[0], byte-exact
    against the bytes written (size None: must answer 404); -> seconds
    of each GET."""
    from seaweedfs_tpu_torch.wdclient import pool

    def one(item):
        fid, start, size = item
        url = urls_of(fid)[0]
        t0 = time.perf_counter()
        r = pool.get(url, timeout=120)
        dt = time.perf_counter() - t0
        if size is None:
            if r.status != 404:
                raise AssertionError(f"{phase}: GET {url} of a deleted "
                                     f"needle: {r.status}")
        elif r.status != 200 or r.data != payload[start:start + size]:
            raise AssertionError(f"{phase}: GET {url}: {r.status}, "
                                 f"{len(r.data)} B, not the bytes written")
        return dt

    return _in_threads(one, items)


def _ec_shard_files(fleet: _Fleet, base_name: str, geo: Geometry) -> dict:
    """{shard id: (server address, path)} over the running servers."""
    out = {}
    for addr, (_, d) in fleet.volumes().items():
        for sid in range(geo.total_shards):
            path = geo.shard_file_name(os.path.join(d, base_name), sid)
            if os.path.exists(path):
                if sid in out:
                    raise AssertionError(f"shard {sid} of {base_name} on "
                                         f"{out[sid][0]} and {addr}")
                out[sid] = (addr, path)
    return out


def _check_ec(phase: str, fleet: _Fleet, base_name: str, geo: Geometry,
              oracle: list[str]) -> dict:
    """Every shard present once, sha-identical to the numpy coder's;
    -> {shard id: server address}."""
    files = _ec_shard_files(fleet, base_name, geo)
    if sorted(files) != list(range(geo.total_shards)):
        raise AssertionError(f"{phase}: shards {sorted(files)} of "
                             f"{base_name}")
    bad = [sid for sid, (_, path) in files.items()
           if _hash_file(path) != oracle[sid]]
    if bad:
        raise AssertionError(f"{phase}: shards {bad} of {base_name} differ "
                             f"from the numpy cpu coder")
    return {sid: addr for sid, (addr, _) in files.items()}


def _file_crc(path: str) -> tuple[int, int]:
    """(size, CRC-32C) of a file, read in 8 MiB chunks."""
    c = n = 0
    with open(path, "rb") as f:
        while chunk := f.read(8 * MIB):
            c = crc.crc32c(chunk, c)
            n += len(chunk)
    return n, c


def _check_manifests(phase: str, fleet: _Fleet, base_name: str,
                     geo: Geometry, source: str) -> dict[str, list[int]]:
    """Each destination of a streamed encode holds a `.dig` manifest of
    exactly its shards, each entry the size and CRC-32C of the shard
    file on disk; -> {destination: shard ids}."""
    out = {}
    for addr, (_, d) in sorted(fleet.volumes().items()):
        base = os.path.join(d, base_name)
        sids = [s for s in range(geo.total_shards)
                if os.path.exists(geo.shard_file_name(base, s))]
        if addr == source or not sids:
            continue
        if not os.path.exists(base + ".dig"):
            raise AssertionError(f"{phase}: no {base_name}.dig on {addr}")
        manifest = digest.read_ec_manifest(base + ".dig")
        if sorted(manifest) != sids:
            raise AssertionError(f"{phase}: {base_name}.dig on {addr} lists "
                                 f"{sorted(manifest)}, the disk {sids}")
        for sid in sids:
            got = _file_crc(geo.shard_file_name(base, sid))
            want = (manifest[sid].size, manifest[sid].crc)
            if got != want:
                raise AssertionError(f"{phase}: shard {sid} of {base_name} "
                                     f"on {addr} is (size, crc) {got}, its "
                                     f"manifest says {want}")
        out[addr] = sids
    return out


# the shell's line for one streamed volume
STREAMED_LINE = re.compile(
    r"volume (\d+): streamed (\d+) shards from (\S+) \((\d+) bytes "
    r"overlapped, overlap ratio ([\d.]+)(?:, (\d+) resume\(s\))?"
    r"(, fallback copy for .*)?\)")


def _streamed(phase: str, out: str) -> dict[int, dict]:
    """{vid: the streamed line's figures} from an ec.encode's output;
    fails if a destination fell back to the copy."""
    got = {}
    for m in STREAMED_LINE.finditer(out):
        got[int(m.group(1))] = dict(
            source=m.group(3), overlapped=int(m.group(4)),
            ratio=float(m.group(5)), resumes=int(m.group(6) or 0),
            line=m.group(0))
        if m.group(7):
            raise AssertionError(f"{phase}: a destination fell back to the "
                                 f"copy: {m.group(0)}")
    if not got or "fallback" in out:
        raise AssertionError(f"{phase}: ec.encode did not stream:\n{out}")
    return got


def _wait_ec(fleet: _Fleet, vid: int, shards: int, plain: bool) -> None:
    """Wait until the master's topology shows `shards` EC shards of `vid`
    and (`plain`) or not its plain replicas."""
    from seaweedfs_tpu_torch.pb import master_pb2

    stub = rpc.master_stub(rpc.grpc_address(fleet.leader()))
    t0 = time.perf_counter()
    while True:
        topo = stub.VolumeList(master_pb2.VolumeListRequest(),
                               timeout=60).topology_info
        ec = vols = 0
        for dc in topo.data_center_infos:
            for rack in dc.rack_infos:
                for dn in rack.data_node_infos:
                    for disk in dn.disk_infos.values():
                        vols += sum(v.id == vid for v in disk.volume_infos)
                        ec += sum(bin(e.ec_index_bits).count("1")
                                  for e in disk.ec_shard_infos if e.id == vid)
        if ec == shards and bool(vols) == plain:
            return
        if time.perf_counter() - t0 > 120:
            raise AssertionError(f"cluster: the master shows {ec} shards "
                                 f"and {vols} replicas of volume {vid}")
        time.sleep(0.3)


def _wait_sizes(fleet: _Fleet, collection: str, want: int,
                full: float) -> dict[int, int]:
    """Wait until the master lists `want` volumes of `collection`, each
    at least `full` of the size limit (heartbeats carry the sizes);
    -> {vid: size}."""
    from seaweedfs_tpu_torch.pb import master_pb2

    stub = rpc.master_stub(rpc.grpc_address(fleet.leader()))
    t0 = time.perf_counter()
    while True:
        topo = stub.VolumeList(master_pb2.VolumeListRequest(),
                               timeout=60).topology_info
        sizes = {v.id: v.size for dc in topo.data_center_infos
                 for rack in dc.rack_infos for dn in rack.data_node_infos
                 for disk in dn.disk_infos.values()
                 for v in disk.volume_infos if v.collection == collection}
        if len(sizes) == want and min(sizes.values()) >= \
                full * CLUSTER_LIMIT_MB * MIB:
            return sizes
        if time.perf_counter() - t0 > 120:
            raise AssertionError(f"cluster: the master lists {sizes} of "
                                 f"{collection}")
        time.sleep(0.3)


def _multi_stream(phase: str, fleet: _Fleet, rng, payload: bytes,
                  workdir: str, root: str, empty_s: float, fresh: str,
                  flap_at: list[int]) -> dict:
    """Config #4 as an operator runs it: CLUSTER_MULTI volumes of a new
    collection, CLUSTER_MULTI_MB of needles each by 8 clients, then one
    `ec.encode -collection -fullPercent 10` that streams them at once
    (-parallelEncode 4: four VolumeEcShardsGenerateStreamed from their
    sources on one card), while the fresh server drops one incoming
    stream once (its SWFS_FAILPOINTS, at a slab offset in `flap_at`).
    Fails unless exactly that one stream resumed, re-sending less than
    that destination's share, nothing fell back to the copy, every shard
    equals the numpy coder's, every manifest its files, and every needle
    reads back byte-exact through lookups; -> {"gbps": aggregate}."""
    from seaweedfs_tpu_torch.wdclient import MasterClient

    col, geo = "c4", Geometry()
    fleet.shell(f"volume.grow -collection {col} -replication 000 -count "
                f"{CLUSTER_MULTI}")
    needles = _seeded_needles(rng, CLUSTER_MULTI * CLUSTER_MULTI_MB, payload)
    fids, write_s = _submit_all(phase, fleet.master, col, needles, payload,
                                replication="000")
    total = sum(size for _, size in needles)
    sizes = _wait_sizes(fleet, col, CLUSTER_MULTI, CLUSTER_MULTI_FULL / 100)
    mc = MasterClient(fleet.master)
    keep, sources = {}, {}
    for vid in sizes:
        sources[vid], = [loc.url for loc in mc.lookup_volume(vid)]
        keep[vid] = os.path.join(root, f"{col}_{vid}")
        d = fleet.volumes()[sources[vid]][1]
        for ext in (".dat", ".idx"):
            os.link(os.path.join(d, f"{col}_{vid}{ext}"), keep[vid] + ext)
    dat = sum(os.path.getsize(b + ".dat") for b in keep.values())
    k0, s0 = fleet.k1(), fleet.stream_counters()
    src_k0 = {a: _kernel_launches(fleet.port_of(a))
              for a in set(sources.values())}
    out, wall = fleet.shell("lock", f"ec.encode -collection {col} "
                                    f"-fullPercent {CLUSTER_MULTI_FULL}",
                                    "unlock")
    said = _streamed(phase, out)
    for vid in sizes:
        _wait_ec(fleet, vid, geo.total_shards, plain=False)
    k1, s1 = fleet.k1(), fleet.stream_counters()
    src_r4 = {a: _kernel_launches(fleet.port_of(a)).get(("gf_xor", "4"), 0)
              - before.get(("gf_xor", "4"), 0)
              for a, before in sorted(src_k0.items())}
    if not all(src_r4.values()):
        raise AssertionError(f"{phase}: a source did not launch K1 at "
                             f"R = 4: {src_r4}")
    steps = {a: _stream_step(s0.get(a, {}), s1[a]) for a in s1}
    resumes = {(a, k): v for a, st in steps.items() for k, v in st.items()
               if k.startswith("resumes")}
    resumed = sum(st.get('bytes{phase="resume",role="source"}', 0)
                  for st in steps.values())
    flapped = [vid for vid, x in said.items() if x["resumes"]]
    t0 = time.perf_counter()
    oracles = dict(zip(sizes, _all_at_once(
        lambda vid: cpu_oracle_hashes(keep[vid], geo, workdir), sizes)))
    oracle_s = time.perf_counter() - t0
    manifests = {}
    for vid in sizes:
        _check_ec(phase, fleet, f"{col}_{vid}", geo, oracles[vid])
        manifests[vid] = _check_manifests(phase, fleet, f"{col}_{vid}", geo,
                                          sources[vid])
    want = {(said[v]["source"], f'resumes{{peer="{fresh}"}}'): 1
            for v in flapped}
    if sorted(said) != sorted(sizes) or len(flapped) != 1 or \
            resumes != want:
        raise AssertionError(f"{phase}: want {CLUSTER_MULTI} volumes "
                             f"streamed, one stream to {fresh} resumed once: "
                             f"{said}, resumes {resumes}")
    vid = flapped[0]
    share = len(manifests[vid].get(fresh, [])) * geo.shard_size(
        os.path.getsize(keep[vid] + ".dat"))
    if not 0 < resumed < share:
        raise AssertionError(f"{phase}: the resume re-sent {resumed} B of "
                             f"{fresh}'s share of {share} B")
    crcs = fleet.crc_kernels()
    mc = MasterClient(fleet.master)
    got = _get_each(phase, mc.lookup_file_id,
                    [(f, *n) for f, n in zip(fids, needles)], payload)
    gbps = dat / (wall - empty_s) / 1e9
    log(phase, f"config #4: volume.grow of {CLUSTER_MULTI} volumes of "
               f"{col} (000); {len(needles)} needles ({total} B) through "
               f"operation.submit by {SERVER_CLIENTS} clients in "
               f"{write_s:.3f} s, sizes {sizes}; shell lock; ec.encode "
               f"-collection {col} -fullPercent {CLUSTER_MULTI_FULL}; "
               f"unlock: {wall:.3f} s "
               f"= {gbps:.3f} GB/s of .dat ({dat} B) beyond an empty shell; "
               f"overlap ratio by volume "
               f"{ {v: x['ratio'] for v, x in sorted(said.items())} }; "
               f"{fresh} dropped a stream of volume {vid} once at a slab "
               f"offset in {flap_at}: 1 resume re-sent {resumed} B of its "
               f"{share} B share; no fallback; "
               f"{geo.total_shards * CLUSTER_MULTI} shard sha256s match the "
               f"numpy cpu coder ({oracle_s:.1f} s, {CLUSTER_MULTI} at "
               f"once), every destination's .dig its files; stream counters "
               f"by server {steps}; every needle GET byte-exact through "
               f"MasterClient lookups by {SERVER_CLIENTS} readers "
               f"({_ms(got)}); K1 launches at R = 4 by source {src_r4}, "
               f"by R on every server {_k1_step(k0, k1)}; CRC-32C by "
               f"server {crcs}")
    return dict(gbps=gbps)


RAFT_MASTERS = 3  # the cluster phase's masters: one Raft group
RAFT_WAIT_S = 120  # the longest a new leader, or a rejoin, may take
QUERY_ROWS = 400  # records of each Query needle
QUERY_NEEDLE = 1 << 40  # the ids of the Query and resize needles
RESIZE_WIDTH = 32


def _max_volume_id(fleet: _Fleet) -> int:
    """The highest volume id the leader's topology holds, plain or EC."""
    from seaweedfs_tpu_torch.pb import master_pb2

    topo = rpc.master_stub(rpc.grpc_address(fleet.leader())).VolumeList(
        master_pb2.VolumeListRequest(), timeout=60).topology_info
    ids = [0]
    for dc in topo.data_center_infos:
        for rack in dc.rack_infos:
            for dn in rack.data_node_infos:
                for disk in dn.disk_infos.values():
                    ids += [v.id for v in disk.volume_infos]
                    ids += [e.id for e in disk.ec_shard_infos]
    return max(ids)


def _raft_failover(phase: str, fleet: _Fleet) -> dict:
    """SIGKILL of the Raft group's leader; -> seconds until
    `cluster.raft.ps` names a new leader and until an assign succeeds,
    and the new volume's id, which must be above every id assigned
    before the loss."""
    import io

    import grpc

    from seaweedfs_tpu_torch.operation import assign
    from seaweedfs_tpu_torch.shell.env import CommandEnv
    from seaweedfs_tpu_torch.shell.registry import run_command

    old = fleet.lead()
    before = _max_volume_id(fleet)
    port = fleet.port_of(old)
    name = next(n for n, (_, _, p, _) in fleet.procs.items()
                if p == port and n.startswith("master"))
    proc = fleet.procs[name][0]
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    t0 = time.perf_counter()
    env = CommandEnv(",".join(f"127.0.0.1:{p}" for p in fleet.master_ports
                              if p != port))
    while True:
        out = io.StringIO()
        try:
            rc = run_command(env, "cluster.raft.ps", out)
        except grpc.RpcError:
            rc = 1
        m = re.search(r"(\S+) Voter \*leader\*", out.getvalue())
        if rc == 0 and m and m.group(1) != old:
            break
        if time.perf_counter() - t0 > RAFT_WAIT_S:
            raise AssertionError(f"{phase}: no new leader after the loss of "
                                 f"{old}: {out.getvalue()}")
        time.sleep(0.1)
    ps_s = time.perf_counter() - t0
    new = fleet.lead()
    if new != m.group(1):
        raise AssertionError(f"{phase}: cluster.raft.ps names {m.group(1)}, "
                             f"{new} leads")
    while True:
        a = assign(fleet.master, collection="raft")
        if not a.error:
            break
        if time.perf_counter() - t0 > RAFT_WAIT_S:
            raise AssertionError(f"{phase}: no assign after the loss of "
                                 f"{old}: {a.error}")
        time.sleep(0.1)
    assign_s = time.perf_counter() - t0
    new_vid = int(a.fid.split(",")[0])
    if new_vid <= before:
        raise AssertionError(f"{phase}: the new leader assigned volume "
                             f"{new_vid}, not above {before}")
    fleet.wait_nodes(set(fleet.volumes()))
    rpc.reset_channels()
    psout = out.getvalue().strip().replace("\n", "; ")
    log(phase, f"SIGKILL of the Raft leader {old}: `cluster.raft.ps` named "
               f"{new} after {ps_s:.3f} s (\"{psout}\"), an assign "
               f"succeeded after {assign_s:.3f} s; the new volume {new_vid} "
               f"is above every id assigned before the loss ({before}): "
               f"MaxVolumeId was replicated; every volume server registered "
               f"with the new leader")
    return dict(name=name, port=port, old=old, new=new, ps_s=ps_s,
                assign_s=assign_s)


def _raft_rejoin(phase: str, fleet: _Fleet, rf: dict) -> dict:
    """The killed master restarted on its -mdir rejoins as a follower;
    `cluster.raft.remove` and `cluster.raft.add` of it from the shell."""
    addr, port = rf["old"], rf["port"]
    t0 = time.perf_counter()
    fleet._spawn(rf["name"] + "-again", fleet.master_args[rf["name"]], port,
                 "")
    leader = fleet.lead()
    while True:
        try:
            st = _json_get(port, "/cluster/raft/status")
        except (OSError, ValueError):
            st = {}
        if st.get("role") == "follower" and st.get("leader") == leader:
            break
        if time.perf_counter() - t0 > RAFT_WAIT_S:
            raise AssertionError(f"{phase}: {addr} did not rejoin: {st}")
        time.sleep(0.1)
    rejoin_s = time.perf_counter() - t0
    rpc.reset_channels()
    out, rm_s = fleet.shell("lock", f"cluster.raft.remove -id={addr}",
                            "unlock")
    peers = _json_get(fleet.master_port, "/cluster/raft/status")["peers"]
    if f"removed {addr}" not in out or addr in peers:
        raise AssertionError(f"{phase}: cluster.raft.remove said:\n{out}\n"
                             f"the leader's peers {peers}")
    out, add_s = fleet.shell("lock", f"cluster.raft.add -id={addr}",
                             "unlock")
    peers = _json_get(fleet.master_port, "/cluster/raft/status")["peers"]
    if f"added {addr}" not in out or addr not in peers:
        raise AssertionError(f"{phase}: cluster.raft.add said:\n{out}\n"
                             f"the leader's peers {peers}")
    ps, _ = fleet.shell("cluster.raft.ps")
    members = re.findall(r"(\S+) Voter", ps)
    # a membership change may move the lead: what follows asks the
    # leader that is now
    leads = fleet.lead()
    fleet.wait_nodes(set(fleet.volumes()))
    if sorted(members) != sorted(f"127.0.0.1:{p}"
                                 for p in fleet.master_ports):
        raise AssertionError(f"{phase}: cluster.raft.ps:\n{ps}")
    log(phase, f"{addr} restarted on its -mdir: a follower of {leader} "
               f"after {rejoin_s:.3f} s; shell cluster.raft.remove "
               f"({rm_s:.3f} s) and cluster.raft.add ({add_s:.3f} s) of it: "
               f"the leader's peers without it, then with it; "
               f"cluster.raft.ps lists {len(members)} voters; {leads} "
               f"leads")
    return dict(rejoin_s=rejoin_s)


def _query_records(rng) -> list[dict]:
    names = ("ann", "bob", "cy", "dee", "eve")
    return [{"id": i, "name": names[int(rng.integers(len(names)))],
             "age": int(rng.integers(18, 90))} for i in range(QUERY_ROWS)]


def _png(rng) -> bytes:
    """A seeded RGB image as PNG bytes: through PIL where the machine has
    it, else a stored-deflate PNG built here."""
    import zlib

    w, h = 97, 61
    pixels = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    try:
        from PIL import Image
    except ImportError:
        raw = b"".join(b"\x00" + pixels[y].tobytes() for y in range(h))

        def chunk(kind, body):
            return (struct.pack(">I", len(body)) + kind + body
                    + struct.pack(">I", zlib.crc32(kind + body)))

        return (b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    import io

    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, format="PNG")
    return buf.getvalue()


def _cli(phase: str, fleet: _Fleet, *args: str) -> tuple[str, float]:
    """One `python3 -m seaweedfs_tpu_torch` command as a process, which
    must exit 0; -> (its output, seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch", *args],
                       cwd=HERE, env=fleet.env, capture_output=True,
                       text=True, timeout=CLUSTER_CALL_S)
    if r.returncode != 0:
        raise AssertionError(f"{phase}: {' '.join(args)} exited "
                             f"{r.returncode}:\n{r.stdout}\n"
                             f"{r.stderr[-4000:]}")
    return r.stdout, time.perf_counter() - t0


def _sha_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(MIB), b""):
            h.update(block)
    return h.hexdigest()


def _extras(phase: str, fleet: _Fleet, vid: int, replicas: list[str],
            root: str, rng) -> dict:
    """Before the encode of `vid`: `backup` of the live volume in full;
    a JSON, a gzipped CSV and a PNG needle written into it; the PNG
    resized on read through the C++ plane's hand-off to Python; the
    master's and a volume server's /ui; `backup` again (incremental),
    both as processes of the port; -> what the Query after the loss
    needs."""
    import gzip

    from seaweedfs_tpu_torch import images
    from seaweedfs_tpu_torch.operation import upload_data
    from seaweedfs_tpu_torch.storage.volume import Volume

    src = replicas[0]
    bdir = os.path.join(root, "backup")
    out, full_s = _cli(phase, fleet, "backup", "-server", src, "-volumeId",
                       str(vid), "-dir", bdir)
    if "full backup" not in out:
        raise AssertionError(f"{phase}: backup said {out!r}")
    recs = _query_records(rng)
    js = "".join(json.dumps(r) + "\n" for r in recs).encode()
    csv_text = "id,name,age\n" + "".join(
        f"{r['id']},{r['name']},{r['age']}\n" for r in recs)
    gz = gzip.compress(csv_text.encode(), mtime=0)
    png = _png(rng)
    extra = {}
    for i, (key, data, mime) in enumerate((
            ("json", js, "application/json"),
            ("csv", gz, "application/gzip"), ("png", png, "image/png"))):
        # into the volume itself, through its primary (which replicates)
        fid = f"{vid},{format_needle_id_cookie(QUERY_NEEDLE + i, 0x5EED)}"
        r = upload_data(f"http://{src}/{fid}", data, mime=mime)
        if r.error:
            raise AssertionError(f"{phase}: the {key} needle: {r.error}")
        extra[key] = (fid, data)

    # the resize: the plane hands every GET with a query string to Python
    have_pil = images._HAS_PIL
    want = (images.resized(png, RESIZE_WIDTH, 0, "")[0] if have_pil
            else png)
    conn = http.client.HTTPConnection("127.0.0.1", fleet.port_of(src),
                                      timeout=120)
    try:
        status, body, hopped = _request(
            conn, "GET", f"/{extra['png'][0]}?width={RESIZE_WIDTH}")
        if status != 200 or body != want or not hopped:
            raise AssertionError(f"{phase}: ?width={RESIZE_WIDTH}: {status},"
                                 f" {len(body)} B, 307 followed {hopped}")
        # the status pages
        pages = {}
        for name, port, must in (
                ("master", fleet.master_port,
                 [a.encode() for a in fleet.volumes()]),
                ("volume", fleet.port_of(src), [f"<td>{vid}</td>".encode()])):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            try:
                st, page = _http(c, "GET", "/ui")
            finally:
                c.close()
            if st != 200 or not all(m in page for m in must):
                raise AssertionError(f"{phase}: the {name} /ui: {st}, "
                                     f"{len(page)} B")
            pages[name] = len(page)
    finally:
        conn.close()

    # the incremental backup: what the server appended since
    out, inc_s = _cli(phase, fleet, "backup", "-server", src, "-volumeId",
                      str(vid), "-dir", bdir)
    if "incremental backup" not in out:
        raise AssertionError(f"{phase}: the second backup said {out!r}")
    files = rpc.volume_stub(rpc.grpc_address(src)).ReadVolumeFileStatus(
        vs.ReadVolumeFileStatusRequest(volume_id=vid),
        timeout=60).file_count
    v = Volume(bdir, "c1", vid)
    try:
        held = v.file_count()
        for key, (fid, data) in extra.items():
            n = v.read_needle(int(fid.split(",")[1][:-8], 16))
            if n.data != data and key != "json":
                raise AssertionError(f"{phase}: the backup's {key} needle")
    finally:
        v.close()
    if held != files:
        raise AssertionError(f"{phase}: the backup holds {held} needles, "
                             f"the server {files}")
    log(phase, f"on live volume {vid}: `backup` in full ({full_s:.2f} s), "
               f"a JSON, a gzipped CSV ({QUERY_ROWS} records each) and a "
               f"PNG needle written; the PNG GET ?width={RESIZE_WIDTH} "
               f"through the C++ plane's 307 to Python: "
               f"{'resized by PIL, the bytes of images.resized' if have_pil else 'no PIL on this host: the stored bytes, as the reference gates it'}"
               f"; /ui of the master ({pages['master']} B, every volume "
               f"server named) and of {src} ({pages['volume']} B, volume "
               f"{vid} named) 200; `backup` again, incremental "
               f"({inc_s:.2f} s): {held} needles as the server holds; both "
               f"as processes of the port")
    return dict(records=recs, json=extra["json"][0], csv=extra["csv"][0])


def _tools_step(phase: str, fleet: _Fleet, keep: str, collection: str,
                vid: int) -> None:
    """`fix`, `compact` and `export` (processes of the port) on a copy of
    a volume never compacted: `fix` of the copy without its .idx gives
    the .idx back byte for byte (compaction writes an .idx in another
    order than the .dat's), and `export` writes every live needle."""
    tdir = os.path.join(os.path.dirname(keep), "tools")
    os.mkdir(tdir)
    name = f"{collection}_{vid}"
    shutil.copyfile(keep + ".dat", os.path.join(tdir, name + ".dat"))
    ids, offs, sizes = idx.read_index_file(keep + ".idx")
    live = {int(n): int(z) for n, z in zip(ids, sizes)}
    live = {n for n, z in live.items() if not types.size_is_deleted(z)}
    args = ("-dir", tdir, "-volumeId", str(vid), "-collection", collection)
    _, fix_s = _cli(phase, fleet, "fix", *args)
    if _sha_file(os.path.join(tdir, name + ".idx")) != _sha_file(
            keep + ".idx"):
        raise AssertionError(f"{phase}: fix did not give the .idx back")
    _, cpt_s = _cli(phase, fleet, "compact", *args)
    xdir = os.path.join(tdir, "export")
    _, exp_s = _cli(phase, fleet, "export", *args, "-o", xdir)
    got = {int(f, 16) for _, _, fs in os.walk(xdir) for f in fs}
    if got != live:
        raise AssertionError(f"{phase}: export wrote {len(got)} files of "
                             f"{len(live)} live needles")
    shutil.rmtree(tdir)
    log(phase, f"on a copy of volume {vid} ({collection}, "
               f"{os.path.getsize(keep + '.dat')} B): `fix` without its .idx "
               f"gave the .idx back byte for byte ({fix_s:.2f} s); `compact` "
               f"({cpt_s:.2f} s) and `export` ({exp_s:.2f} s): {len(got)} "
               f"files, every live needle; each a process of the port")


def _query_step(phase: str, fleet: _Fleet, vid: int, ex: dict,
                where: dict) -> dict:
    """The Query RPC over the JSON and the gzipped CSV needle of EC
    volume `vid`, a server of it lost, on a surviving shard holder: the
    records equal what `json` and `csv` give for the same filter."""
    import csv as csv_mod
    import io

    holder = sorted(a for a in set(where.values()) if a in fleet.volumes())[0]
    stub = rpc.volume_stub(rpc.grpc_address(holder))
    k0 = fleet.k1()
    got = {}
    t0 = time.perf_counter()
    for kind, fid in (("json", ex["json"]), ("csv", ex["csv"])):
        req = vs.QueryRequest(from_file_ids=[fid],
                              selections=["name", "age"] if kind == "csv"
                              else [])
        req.filter.field, req.filter.operand, req.filter.value = \
            "age", ">", "50"
        if kind == "csv":
            req.input_serialization.compression_type = "GZIP"
            req.input_serialization.csv_input.file_header_info = "USE"
        else:
            req.input_serialization.json_input.type = "LINES"
        req.output_serialization.json_output.record_delimiter = "\n"
        got[kind] = b"".join(s.records for s in stub.Query(req, timeout=300))
    query_s = time.perf_counter() - t0
    recs = ex["records"]
    want_json = "".join(json.dumps(r) + "\n" for r in recs
                        if r["age"] > 50).encode()
    rows = csv_mod.DictReader(io.StringIO("id,name,age\n" + "".join(
        f"{r['id']},{r['name']},{r['age']}\n" for r in recs)))
    want_csv = "".join(json.dumps({"name": r["name"], "age": int(r["age"])})
                       + "\n" for r in rows
                       if int(r["age"]) > 50).encode()
    if got["json"] != want_json or got["csv"] != want_csv:
        raise AssertionError(f"{phase}: Query on {holder}: json "
                             f"{got['json'][:200]!r}, csv "
                             f"{got['csv'][:200]!r}")
    k1 = _k1_step(k0, fleet.k1())
    log(phase, f"Query (gRPC) on {holder} over the JSON and the gzipped "
               f"CSV needle of EC volume {vid} with a server lost, filter "
               f"age > 50: {got['json'].count(b'{')} and "
               f"{got['csv'].count(b'{')} records, equal to what json and "
               f"csv give ({query_s:.3f} s); K1 launches by R {k1}")
    return dict(query_s=query_s, k1=k1)


def cluster_phase(seed: int, workdir: str, card: str, smi: str) -> dict:
    """The operator's path through a cluster of processes on the card
    (see the module docstring); -> K1's launches. Which encode runs
    where: the 128 MiB volume of c1 and the four volumes of c4 take the
    default, streamed path (VolumeEcShardsGenerateStreamed on each source,
    K1 there while the shards stream); the RS(6,3) volume of c5 the copy
    path (`-stream 0`: VolumeEcShardsGenerate, then VolumeEcShardsCopy)."""
    from seaweedfs_tpu_torch.pb import master_pb2
    from seaweedfs_tpu_torch.wdclient import MasterClient, pool

    phase = "cluster"
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix=f"{phase}-", dir=workdir)
    fleet = _Fleet(phase, root)
    cached = _build.library_path("gf_xor.cu").exists()
    try:
        t0 = time.perf_counter()
        fleet.spawn_raft_masters(RAFT_MASTERS)
        for i, rack in enumerate(CLUSTER_RACKS):
            fleet.spawn_volume(f"v{i}", rack)
        up_s = fleet.wait_up(
            ["master"] + [f"master{i}" for i in range(1, RAFT_MASTERS)]
            + [f"v{i}" for i in range(len(CLUSTER_RACKS))])
        rpc.reset_channels()  # no channel dialled before the listeners
        _, empty_s = fleet.shell("volume.list")
        nodes = [f"{n[0]}-{n[-1]}" if n[-1] - n[0] + 1 == len(n) else n
                 for n in numa.node_cpus()]
        log(phase, f"{RAFT_MASTERS} masters of one Raft group (-peers, "
                   f"-mdir, -volumeSizeLimitMB {CLUSTER_LIMIT_MB} "
                   f"-defaultReplication 001; {fleet.master.split(',')[0]} "
                   f"leads) and {len(CLUSTER_RACKS)} "
                   f"volume servers (default coder, racks "
                   f"{'/'.join(CLUSTER_RACKS)}) started at once: all "
                   f"registered in {up_s:.2f} s; K1's library was "
                   f"{'already built' if cached else 'not built yet'}; an "
                   f"empty shell process takes {empty_s:.2f} s; the host's "
                   f"NUMA layout: {len(nodes)} node(s), CPUs {nodes} "
                   f"(pinning gate SWFS_EC_DISPATCH_PIN off)")

        # 1. writes: one volume with a same-rack replica, 8 clients
        out, _ = fleet.shell("volume.grow -collection c1 -replication 001 "
                             "-count 1")
        rng = np.random.default_rng(seed)
        payload = rng.bytes(CLUSTER_VOLUME_MB * MIB)
        needles = _seeded_needles(rng, CLUSTER_VOLUME_MB, payload)
        fids, write_s = _submit_all(phase, fleet.master, "c1", needles,
                                    payload)
        vids = {int(f.split(",")[0]) for f in fids}
        if len(vids) != 1:
            raise AssertionError(f"{phase}: writes landed in volumes {vids}")
        vid = vids.pop()
        mc = MasterClient(fleet.master)
        replicas = [loc.url for loc in mc.lookup_volume(vid)]
        if len(replicas) != 2:
            raise AssertionError(f"{phase}: volume {vid} on {replicas}")
        counts = [rpc.volume_stub(rpc.grpc_address(a)).ReadVolumeFileStatus(
            vs.ReadVolumeFileStatusRequest(volume_id=vid), timeout=60)
            for a in replicas]
        if {c.file_count for c in counts} != {len(needles)}:
            raise AssertionError(f"{phase}: replicas hold "
                                 f"{[c.file_count for c in counts]} of "
                                 f"{len(needles)} needles")
        total = sum(size for _, size in needles)
        log(phase, f"volume.grow: volume {vid} on {replicas} (same rack); "
                   f"{len(needles)} needles ({total} B of 1-64 KiB) through "
                   f"operation.submit by {SERVER_CLIENTS} clients in "
                   f"{write_s:.3f} s = {total / write_s / 1e9:.3f} GB/s of "
                   f"needle bytes ({len(needles) / write_s:.0f} writes/s, "
                   f"each on both replicas: {counts[0].dat_file_size} and "
                   f"{counts[1].dat_file_size} B of .dat)")

        # 2. a seeded 10% deleted through the primary, then volume.vacuum
        gone = set(rng.choice(len(needles),
                              size=int(len(needles) * CLUSTER_DELETED),
                              replace=False).tolist())

        def delete(i):
            r = pool.delete(f"http://{replicas[0]}/{fids[i]}", timeout=120)
            if r.status != 202:
                raise AssertionError(f"{phase}: DELETE {fids[i]}: {r.status}")

        t0 = time.perf_counter()
        _in_threads(delete, sorted(gone))
        del_s = time.perf_counter() - t0
        out, vac_s = fleet.shell("volume.vacuum -garbageThreshold 0.05")
        after = []
        for a in replicas:
            stub = rpc.volume_stub(rpc.grpc_address(a))
            st = stub.ReadVolumeFileStatus(vs.ReadVolumeFileStatusRequest(
                volume_id=vid), timeout=60)
            ratio = stub.VacuumVolumeCheck(vs.VacuumVolumeCheckRequest(
                volume_id=vid), timeout=60).garbage_ratio
            after.append((st.file_count, st.compaction_revision,
                          st.dat_file_size, ratio))
        if any(fc != len(needles) - len(gone) or rev != 1 or ratio != 0
               for fc, rev, _, ratio in after):
            raise AssertionError(f"{phase}: after volume.vacuum the replicas "
                                 f"report (files, revision, .dat, garbage) "
                                 f"{after}")
        items = [(fids[i], *needles[i]) if i not in gone
                 else (fids[i], 0, None) for i in range(len(needles))]
        back_ms = []
        for a in replicas:
            back_ms += _get_each(phase, lambda fid, a=a: [f"http://{a}/{fid}"],
                                 items, payload)
        log(phase, f"{len(gone)} needles deleted through the primary in "
                   f"{del_s:.3f} s; volume.vacuum -garbageThreshold 0.05 "
                   f"(shell, {vac_s:.3f} s): both replicas compacted and "
                   f"committed, (files, revision, .dat B, garbage) {after}; "
                   f"every needle read back from each replica, byte-exact "
                   f"or 404 ({_ms(back_ms)})")

        # 2b. the offline tools on the live volume; the Query needles, the
        # resize and the status pages
        ex = _extras(phase, fleet, vid, replicas, root, rng)

        # 3. ec.encode from the shell: the default, streamed path (the
        # source streams each destination's shards while K1 runs)
        source = replicas[0]
        src_name, src_dir = fleet.volumes()[source]
        base_name = f"c1_{vid}"
        keep = os.path.join(root, "source")
        for ext in (".dat", ".idx"):
            os.link(os.path.join(src_dir, base_name + ext), keep + ext)
        dat_bytes = os.path.getsize(keep + ".dat")
        k0 = fleet.k1()
        src_k0 = _kernel_launches(fleet.port_of(source))
        s0 = _stream_counters(fleet.port_of(source))
        out, enc_s = fleet.shell("lock", f"ec.encode -volumeId {vid}",
                                 "unlock")
        spread = [x for x in out.splitlines() if "shards spread" in x]
        said = _streamed(phase, out)[vid]
        _wait_ec(fleet, vid, 14, plain=False)
        k1 = fleet.k1()
        src_k1 = {int(r): n - src_k0.get((k, r), 0)
                  for (k, r), n in _kernel_launches(
                      fleet.port_of(source)).items()
                  if k == "gf_xor" and r and n - src_k0.get((k, r), 0)}
        sstep = _stream_step(s0, _stream_counters(fleet.port_of(source)))
        geo = Geometry()
        t0 = time.perf_counter()
        oracle = cpu_oracle_hashes(keep, geo, workdir)
        oracle_s = time.perf_counter() - t0
        where = _check_ec(phase, fleet, base_name, geo, oracle)
        listing, _ = fleet.shell("volume.list")
        holders = listing.count(f"ec volume id:{vid} ")
        if holders != len(CLUSTER_RACKS):
            raise AssertionError(f"{phase}: volume.list shows volume {vid} "
                                 f"on {holders} servers:\n{listing}")
        by_server: dict[str, list[int]] = {}
        for sid, a in sorted(where.items()):
            by_server.setdefault(a, []).append(sid)
        manifests = _check_manifests(phase, fleet, base_name, geo, source)
        crcs = fleet.crc_kernels()
        enc_k1 = _k1_step(k0, k1)
        log(phase, f"shell lock; ec.encode -volumeId {vid}; unlock (the "
                   f"default, streamed): {enc_s:.3f} s = "
                   f"{dat_bytes / (enc_s - empty_s) / 1e9:.3f} GB/s of .dat "
                   f"beyond an empty shell ({dat_bytes} B; placement, then "
                   f"VolumeEcShardsGenerateStreamed on {source} streaming "
                   f"each destination's shards while it encodes, index "
                   f"copies, mounts, both replicas deleted); the shell: "
                   f"\"{said['line']}\"; "
                   f"{spread[0].lstrip('> ') if spread else ''}; 14 shard "
                   f"sha256s match the numpy cpu coder ({oracle_s:.1f} s); "
                   f"the .dig manifests of {len(manifests)} destinations "
                   f"hold each shard's size and CRC-32C as on disk; "
                   f"volume.list shows the EC volume on all {holders} "
                   f"servers; the source's stream counters {sstep}; K1 "
                   f"launches by R on the source {src_k1}, on every server "
                   f"{enc_k1}; CRC-32C by server {crcs}")
        if not src_k1.get(4):
            raise AssertionError(f"{phase}: ec.encode did not launch K1 at "
                                 f"R = 4 on the source: {src_k1}")
        if sstep.get('streams{outcome="failed"}') or said["resumes"] or \
                len(manifests) != len(CLUSTER_RACKS) - 1:
            raise AssertionError(f"{phase}: the streamed encode resumed, "
                                 f"failed or missed a destination: {sstep}, "
                                 f"{said}, manifests {manifests}")

        # 3b. the Raft group's leader lost: what follows runs through the
        # new one
        rf = _raft_failover(phase, fleet)

        # 4. the server that holds 4 shards lost; 8 readers through lookups
        victim = next(a for a, sids in sorted(by_server.items())
                      if len(sids) == 4)
        lost = by_server[victim]
        fleet.kill(victim)
        ids, offs, sizes = idx.read_index_file(keep + ".idx")
        where_of = {int(n): (types.stored_to_actual_offset(int(o)),
                             types.actual_size(int(z)))
                    for n, o, z in zip(ids, offs, sizes)}
        live = [i for i in range(len(needles)) if i not in gone]
        extents = [(i, *where_of[int(fids[i].split(",")[1][:-8], 16)])
                   for i in live]
        touching, others = split_by_lost(geo, dat_bytes, extents, lost)
        touching = set(touching)
        mc = MasterClient(fleet.master)
        k2 = fleet.k1()
        got_ms = _get_each(phase, mc.lookup_file_id,
                           [(fids[i], *needles[i]) for i in live], payload)
        k3 = fleet.k1()
        deg = [t for i, t in zip(live, got_ms) if i in touching]
        rest = [t for i, t in zip(live, got_ms) if i not in touching]
        get_k1 = _k1_step(k2, k3)
        log(phase, f"SIGKILL of {victim} (shards {lost}); the master "
                   f"dropped it; every surviving needle GET byte-exact "
                   f"through MasterClient lookups by {SERVER_CLIENTS} "
                   f"readers: {len(deg)} on a lost shard "
                   f"({_ms(deg)}), {len(rest)} others ({_ms(rest)}); K1 "
                   f"launches by R {get_k1}")
        if not sum(get_k1.values()):
            raise AssertionError(f"{phase}: the degraded GETs never launched "
                                 f"K1")
        qs = _query_step(phase, fleet, vid, ex, where)

        # 5. a fresh, empty server in the lost one's rack; ec.rebuild. It
        # drops one incoming shard stream once, at a slab about a third
        # into a config #4 volume's shards (step 6b): wire chunks are one
        # or two slabs, so of two slab offsets in a row one starts a chunk
        slab = ec_files._pick_batch(geo.small_block,
                                    ec_files.DEFAULT_BATCH_SIZE)
        third = CLUSTER_MULTI_MB * MIB // geo.data_shards // 3 // slab * slab
        flap_at = [max(slab, third) + i * slab for i in range(3)]
        fleet.spawn_volume("v4", fleet.rack_of[victim], env={
            "SWFS_FAILPOINTS": "ec.stream.slab=error(1.0x1)@" + "|".join(
                f"off={o}," for o in flap_at)})
        fresh_s = fleet.wait_up(["v4"])
        fresh = next(a for a, (n, _) in fleet.volumes().items() if n == "v4")
        out, reb_s = fleet.shell("lock", f"ec.rebuild -volumeId {vid}",
                                 "unlock")
        k4 = fleet.k1()
        m = re.search(r"rebuilt shards (\[[^]]*\]) on (\S+) .*?, (\d+) bytes",
                      out)
        if not m or sorted(json.loads(m.group(1))) != sorted(lost):
            raise AssertionError(f"{phase}: ec.rebuild said:\n{out}")
        survivor_bytes = int(m.group(3))
        _wait_ec(fleet, vid, 14, plain=False)
        where = _check_ec(phase, fleet, base_name, geo, oracle)
        reb_k1 = _k1_step(k3, k4)
        log(phase, f"a fresh server up in {fresh_s:.2f} s; shell ec.rebuild "
                   f"-volumeId {vid}: shards {lost} rebuilt on {m.group(2)} "
                   f"in {reb_s:.3f} s = "
                   f"{survivor_bytes / (reb_s - empty_s) / 1e9:.3f} GB/s of "
                   f"survivors read ({survivor_bytes} B) beyond an empty "
                   f"shell, sha-identical; K1 launches by R {reb_k1}")
        if not reb_k1.get(len(lost)):
            raise AssertionError(f"{phase}: the rebuild launched K1 by R "
                                 f"{reb_k1}")

        # 6. a byte flipped in one shard on disk; volume.scrub -full right
        # away (a server whose cached shard map predates the rebuild asks
        # the master again)
        node = sorted(a for a in set(where.values()) if a != m.group(2))[0]
        sid = min(s for s, a in where.items() if a == node)
        path = geo.shard_file_name(os.path.join(
            fleet.volumes()[node][1], base_name), sid)
        flip_at = os.path.getsize(path) // 2 + 12345
        with open(path, "r+b") as f:
            f.seek(flip_at)
            b = f.read(1)
            f.seek(flip_at)
            f.write(bytes([b[0] ^ 0x5A]))
        first, scrub_s = fleet.shell(
            f"volume.scrub -node={node} -volumeId {vid} -full")
        second, _ = fleet.shell(
            f"volume.scrub -node={node} -volumeId {vid} -full")
        k5 = fleet.k1()
        if "1 finding(s), 1 repaired" not in first or \
                f"shard={sid} [repaired]" not in first:
            raise AssertionError(f"{phase}: the scrub said:\n{first}")
        if " 0 finding(s)" not in second:
            raise AssertionError(f"{phase}: a second scrub said:\n{second}")
        _check_ec(phase, fleet, base_name, geo, oracle)
        said_scrub = next(x for x in first.splitlines()
                          if "scrubbed" in x).lstrip("> ")
        log(phase, f"byte {flip_at} of shard {sid} flipped on {node}: shell "
                   f"volume.scrub -full found and repaired it in "
                   f"{scrub_s:.3f} s ({said_scrub}); a "
                   f"second pass found none; shards sha-identical; K1 "
                   f"launches by R {_k1_step(k4, k5)}")

        # 6a. the killed master back: a follower, removed and added again
        rj = _raft_rejoin(phase, fleet, rf)

        # 6b. config #4: volumes streamed at once, the fresh server flapping
        multi = _multi_stream(phase, fleet, rng, payload, workdir, root,
                              empty_s, fresh, flap_at)
        # 6c. the offline tools on a copy of one of those volumes
        c4 = min(int(f[3:-4]) for f in os.listdir(root)
                 if f.startswith("c4_") and f.endswith(".dat"))
        _tools_step(phase, fleet, os.path.join(root, f"c4_{c4}"), "c4", c4)
        k5 = fleet.k1()

        # 7. ec.decode back to a plain volume; every needle GET once more
        out, dec_s = fleet.shell("lock", f"ec.decode -volumeId {vid}",
                                 "unlock")
        _wait_ec(fleet, vid, 0, plain=True)
        k6 = fleet.k1()
        mc = MasterClient(fleet.master)
        again = _get_each(phase, mc.lookup_file_id,
                          [(fids[i], *needles[i]) for i in live], payload)
        said = [x for x in out.splitlines() if "decoded back" in x]
        if not said:
            raise AssertionError(f"{phase}: ec.decode said:\n{out}")
        log(phase, f"shell ec.decode -volumeId {vid}: {dec_s:.3f} s "
                   f"({said[0].lstrip('> ')}); every surviving needle GET byte-exact from the plain "
                   f"volume ({_ms(again)}); K1 launches by R "
                   f"{_k1_step(k5, k6)}")

        # 8. config #5: a second collection at RS(6,3), a server lost
        fleet.shell("volume.grow -collection c5 -replication 001 -count 1")
        small = _seeded_needles(rng, CLUSTER_SMALL_MB, payload)
        sfids, swrite_s = _submit_all(phase, fleet.master, "c5", small,
                                      payload)
        svids = {int(f.split(",")[0]) for f in sfids}
        if len(svids) != 1:
            raise AssertionError(f"{phase}: c5 writes landed in {svids}")
        svid = svids.pop()
        sreplicas = [loc.url for loc in
                     MasterClient(fleet.master).lookup_volume(svid)]
        skeep = os.path.join(root, "small")
        for ext in (".dat", ".idx"):
            os.link(os.path.join(fleet.volumes()[sreplicas[0]][1],
                                 f"c5_{svid}{ext}"), skeep + ext)
        out, senc_s = fleet.shell(
            "lock", f"ec.encode -volumeId {svid} -dataShards 6 "
                    f"-parityShards 3 -stream 0", "unlock")
        if "generated 9 shards" not in out or "streamed" in out:
            raise AssertionError(f"{phase}: ec.encode -stream 0 said:\n{out}")
        _wait_ec(fleet, svid, SMALL_GEO.total_shards, plain=False)
        soracle = cpu_oracle_hashes(skeep, SMALL_GEO, workdir)
        swhere = _check_ec(phase, fleet, f"c5_{svid}", SMALL_GEO, soracle)
        sby: dict[str, list[int]] = {}
        for sid, a in sorted(swhere.items()):
            sby.setdefault(a, []).append(sid)
        svictim = max(sorted(sby), key=lambda a: len(sby[a]))
        fleet.kill(svictim)
        mc = MasterClient(fleet.master)
        sget = _get_each(phase, mc.lookup_file_id,
                         [(f, *n) for f, n in zip(sfids, small)], payload)
        k7 = fleet.k1()
        sbytes = os.path.getsize(skeep + ".dat")
        log(phase, f"config #5: {len(small)} needles in collection c5 "
                   f"({swrite_s:.3f} s); shell ec.encode -volumeId {svid} "
                   f"-dataShards 6 -parityShards 3 -stream 0 (generate, "
                   f"then copy): {senc_s:.3f} s "
                   f"({sbytes} B), 9 shard sha256s match the numpy cpu "
                   f"coder, spread {sby}; SIGKILL of {svictim} (shards "
                   f"{sby[svictim]}); every needle GET byte-exact "
                   f"({_ms(sget)}); K1 launches by R {_k1_step(k6, k7)}")

        # 9. SIGTERM to every process
        by_r = fleet.k1()
        # NativeSendfile stays 0 here: every plain needle this phase reads
        # was written at 001 through Python, which tags it with the
        # replica epoch, and the plane serves tagged needles buffered
        planes = fleet.planes()
        log(phase, f"every volume server on the C++ plane: (NativeDataPlane,"
                   f" NativeRequests, NativeSendfile) {planes}; 307s this "
                   f"script followed so far {dict(REDIRECTS)}")
        dirs = {n: d for n, (_, _, _, d) in fleet.procs.items()
                if not n.startswith("master")
                and fleet.procs[n][0].poll() is None}
        rcs = fleet.terminate()
        if set(rcs.values()) != {0}:
            raise AssertionError(f"{phase}: exit codes on SIGTERM {rcs}")
        dirty = [n for n, d in dirs.items()
                 if os.path.exists(recovery.marker_path(d))]
        if dirty:
            raise AssertionError(f"{phase}: dirty marker left by {dirty}")
        log(phase, f"SIGTERM: {sorted(rcs)} exited 0, no dirty marker. "
                   f"writes {total / write_s / 1e9:.3f} GB/s, vacuum "
                   f"{vac_s:.3f} s, encode "
                   f"{dat_bytes / (enc_s - empty_s) / 1e9:.3f} GB/s "
                   f"streamed, {CLUSTER_MULTI} volumes streamed at once "
                   f"{multi['gbps']:.3f} GB/s, "
                   f"GETs on a lost shard {_ms(deg)}, "
                   f"rebuild {survivor_bytes / (reb_s - empty_s) / 1e9:.3f} "
                   f"GB/s, scrub {scrub_s:.3f} s, decode {dec_s:.3f} s; "
                   f"Raft failover: cluster.raft.ps {rf['ps_s']:.3f} s, "
                   f"assign {rf['assign_s']:.3f} s, rejoin "
                   f"{rj['rejoin_s']:.3f} s; Query {qs['query_s']:.3f} s; "
                   f"gf_xor by R over every server {dict(sorted(by_r.items()))}"
                   f"; phase wall {time.perf_counter() - t_phase:.3f} s; "
                   f"nvidia-smi: {smi}")
        return dict(launches=sum(by_r.values()))
    except BaseException:
        log(phase, f"log tails:\n{fleet.log_tails()}")
        raise
    finally:
        fleet.close()
        rpc.reset_channels()
        shutil.rmtree(root)


# -- filer --------------------------------------------------------------------

FILER_LIMIT_MB = 256  # the master's -volumeSizeLimitMB
FILER_COLLECTION = "fc"
FILER_SMALL = 250  # files of 1-64 KiB: FILER_WIDE in one directory,
FILER_WIDE = 150  # the rest in FILER_DIRS nested directories
FILER_DIRS = 64
FILER_LARGE = 16  # files of 8-64 MiB: 2-16 chunks at the default -maxMB 4
FILER_LARGE_MIB = (8, 64)
FILER_CHUNK = 4 * MIB
FILER_PAGE = 100  # the paged listing's limit
FILER_SAMPLE = 200  # files listed and read back after the restart
FILER_PAYLOAD_MB = 128


def _filer_files(rng) -> list[tuple]:
    """[(path, start, size)] of the seeded file set: slices of the
    payload; one text file, for fs.cat."""
    files = [("/fs/readme.txt", -1, 0)]
    for i in range(FILER_SMALL):
        size = int(rng.integers(1, 64 * 1024 + 1))
        start = int(rng.integers(0, FILER_PAYLOAD_MB * MIB - size))
        d = ("/fs/wide" if i < FILER_WIDE else
             f"/fs/d{(i % FILER_DIRS) // 8}/e{i % 8}")
        files.append((f"{d}/s{i:05d}", start, size))
    for j in range(FILER_LARGE):
        lo, hi = FILER_LARGE_MIB
        size = int(rng.integers(lo * MIB, hi * MIB + 1))
        start = int(rng.integers(0, FILER_PAYLOAD_MB * MIB - size))
        files.append((f"/fs/big/L{j:02d}", start, size))
    return files


class _FilerFiles:
    """The written set: path -> bytes, held as slices of one payload."""

    def __init__(self, rng):
        self.payload = rng.bytes(FILER_PAYLOAD_MB * MIB)
        self.text = "".join(chr(int(c)) for c in
                            rng.integers(32, 127, 3000)).encode()
        self.items = {p: (start, size) for p, start, size in
                      _filer_files(rng)}

    def data(self, path: str):
        start, size = self.items[path]
        if start < 0:
            return self.text
        return memoryview(self.payload)[start:start + size]


def _filer_put_all(phase: str, port: int, files: _FilerFiles, paths
                   ) -> tuple[dict, float]:
    """PUT every path through the filer's HTTP API by 8 clients;
    -> ({path: md5 hex}, seconds)."""
    def put(conn, path):
        data = files.data(path)
        conn.request("PUT", path, body=data,
                     headers={"Content-Length": str(len(data))})
        r = conn.getresponse()
        body = r.read()
        if r.status != 201 or json.loads(body)["size"] != len(data):
            raise AssertionError(f"{phase}: PUT {path}: {r.status} {body!r}")
        return hashlib.md5(data).hexdigest()

    t0 = time.perf_counter()
    md5 = _clients(port, put, paths)
    return dict(zip(paths, md5)), time.perf_counter() - t0


def _filer_get_all(phase: str, port: int, files: _FilerFiles, paths,
                   md5: dict) -> list[float]:
    """GET every path through the filer by 8 readers, byte-exact, with
    the ETag the reference gives it (the quoted md5 of the body);
    -> seconds of each GET."""
    def get(conn, path):
        t0 = time.perf_counter()
        conn.request("GET", path)
        r = conn.getresponse()
        body = r.read()
        dt = time.perf_counter() - t0
        if r.status != 200 or body != files.data(path):
            raise AssertionError(f"{phase}: GET {path}: {r.status}, "
                                 f"{len(body)} B, not the bytes written")
        if r.getheader("ETag") != f'"{md5[path]}"':
            raise AssertionError(f"{phase}: GET {path}: ETag "
                                 f"{r.getheader('ETag')}, not the md5")
        return dt

    return _clients(port, get, paths)


def _filer_entries(address: str, directory: str) -> list:
    from seaweedfs_tpu_torch.pb import filer_pb2

    stub = rpc.filer_stub(rpc.grpc_address(address))
    return [r.entry for r in stub.ListEntries(filer_pb2.ListEntriesRequest(
        directory=directory, limit=1 << 20), timeout=120)]


def _filer_volumes(fleet: _Fleet) -> dict[int, tuple[str, str]]:
    """{vid: (server address, dir)} of the collection's non-empty
    volumes, from the volume servers' directories."""
    out = {}
    for addr, (_, d) in fleet.volumes().items():
        for name in os.listdir(d):
            m = re.fullmatch(rf"{FILER_COLLECTION}_(\d+)\.dat", name)
            if m and os.path.getsize(os.path.join(d, name)) > 8:
                out[int(m.group(1))] = (addr, d)
    return out


def _wait_listed(fleet: _Fleet, vols: dict) -> None:
    """Wait until the master's heartbeats show each of `vols` with its
    bytes, so that ec.encode -fullPercent selects every one."""
    from seaweedfs_tpu_torch.pb import master_pb2

    stub = rpc.master_stub(rpc.grpc_address(fleet.leader()))
    want = {vid: os.path.getsize(os.path.join(
        d, f"{FILER_COLLECTION}_{vid}.dat")) for vid, (_, d) in vols.items()}
    t0 = time.perf_counter()
    while True:
        topo = stub.VolumeList(master_pb2.VolumeListRequest(),
                               timeout=60).topology_info
        sizes = {v.id: v.size for dc in topo.data_center_infos
                 for rack in dc.rack_infos for dn in rack.data_node_infos
                 for disk in dn.disk_infos.values()
                 for v in disk.volume_infos
                 if v.collection == FILER_COLLECTION}
        if all(sizes.get(vid) == n for vid, n in want.items()):
            return
        if time.perf_counter() - t0 > 120:
            raise AssertionError(f"filer: the master lists {sizes}, the "
                                 f"disks hold {want}")
        time.sleep(0.3)


S3_BUCKET = "smoke"
S3_OBJECTS = 120  # objects of 1-64 KiB over S3_PREFIXES prefixes
S3_PREFIXES = 16
S3_MULTIPART = 4  # objects of S3_MULTIPART_MIB in S3_PART parts
S3_MULTIPART_MIB = (24, 48)
S3_PART = 8 * MIB
S3_PAGE = 10  # ListObjectsV2 max-keys: each prefix's listing pages
S3_IDENTITY = ("phase", "AKPHASE0000000000001", "phase-secret-0001")
S3_ACTIONS = "Read,Write,List,Tagging,Admin"
BENCH_N, BENCH_SIZE, BENCH_COLLECTION = 2000, 4096, "bench"
# runs the CLI as `python3 -m seaweedfs_tpu_torch` does and writes the
# names in sys.modules to argv[1] as the process exits
_MODULES_WRAPPER = """
import atexit, runpy, sys
out = sys.argv[1]


def dump():
    with open(out, "w") as f:
        f.write("\\n".join(sorted(sys.modules)))


atexit.register(dump)
sys.argv = ["seaweedfs_tpu_torch"] + sys.argv[2:]
runpy.run_module("seaweedfs_tpu_torch", run_name="__main__", alter_sys=True)
"""


class _S3Client:
    """SigV4-signed requests to the phase's gateway (the port's signer)
    on a caller's keep-alive connection."""

    def __init__(self, port: int):
        self.port = port
        self.base = f"http://127.0.0.1:{port}"

    def call(self, conn, method: str, path: str, body: bytes = b"",
             headers: dict | None = None):
        """-> (status, body bytes, response)."""
        from seaweedfs_tpu_torch.s3api import sigv4_client

        h = dict(headers or {})
        h.update(sigv4_client.sign_request(method, self.base + path, body,
                                           S3_IDENTITY[1], S3_IDENTITY[2]))
        conn.request(method, path, body=body, headers=h)
        r = conn.getresponse()
        return r.status, r.read(), r


def _s3_objects(rng, payload_len: int) -> tuple[list, list]:
    """([(key, start, size)] of 1-64 KiB, [(key, start, size)] of the
    multipart objects): slices of the filer's payload."""
    small = []
    for i in range(S3_OBJECTS):
        size = int(rng.integers(1, 64 * 1024 + 1))
        small.append((f"p{i % S3_PREFIXES:02d}/o{i:05d}.bin",
                      int(rng.integers(0, payload_len - size)), size))
    large = []
    for j in range(S3_MULTIPART):
        lo, hi = S3_MULTIPART_MIB
        size = int(rng.integers(lo * MIB, hi * MIB + 1))
        large.append((f"mp/m{j}.bin",
                      int(rng.integers(0, payload_len - size)), size))
    return small, large


def _s3_multipart(phase: str, s3: _S3Client, conn, key: str, parts
                  ) -> str:
    """One multipart upload of `parts` (bodies, or (source, None) copies
    by UploadPartCopy); -> the ETag CompleteMultipartUpload answered."""
    path = f"/{S3_BUCKET}/{key}"
    st, body, _ = s3.call(conn, "POST", f"{path}?uploads")
    m = re.search(rb"<UploadId>([^<]+)</UploadId>", body)
    if st != 200 or not m:
        raise AssertionError(f"{phase}: initiate {key}: {st} {body[:300]!r}")
    uid = m.group(1).decode()
    for n, part in enumerate(parts, 1):
        q = f"{path}?partNumber={n}&uploadId={uid}"
        if isinstance(part, str):
            st, body, _ = s3.call(conn, "PUT", q,
                                  headers={"x-amz-copy-source": part})
        else:
            st, body, _ = s3.call(conn, "PUT", q, bytes(part))
        if st != 200:
            raise AssertionError(f"{phase}: part {n} of {key}: {st} "
                                 f"{body[:300]!r}")
    st, body, _ = s3.call(conn, "POST", f"{path}?uploadId={uid}")
    m = re.search(rb'<ETag>"([^"]+)"</ETag>', body)
    if st != 200 or not m:
        raise AssertionError(f"{phase}: complete {key}: {st} "
                             f"{body[:300]!r}")
    return m.group(1).decode()


def _s3_writes(phase: str, fleet: _Fleet, sport: int, faddr: str,
               files: _FilerFiles, rng) -> dict:
    """The S3 step's writes, listings, copies and the CLI's benchmark
    (see the module docstring); -> what the reads after the loss need."""
    from seaweedfs_tpu_torch.iamapi import IAM_CONFIG_DIR, IAM_CONFIG_FILE
    from seaweedfs_tpu_torch.pb import filer_pb2, s3_pb2

    s3 = _S3Client(sport)
    # 1. an identity through the shell, pushed to the gateway's Configure
    t0 = time.perf_counter()
    name, ak, sk = S3_IDENTITY
    out, _ = fleet.shell(
        f"s3.configure -user={name} -access_key={ak} -secret_key={sk} "
        f"-actions={S3_ACTIONS} -apply",
        f"s3.bucket.create -name={S3_BUCKET}", "s3.bucket.list",
        filer=faddr)
    if f"created bucket {S3_BUCKET}" not in out:
        raise AssertionError(f"{phase}: s3.* said:\n{out}")
    doc = rpc.filer_stub(rpc.grpc_address(faddr)).LookupDirectoryEntry(
        filer_pb2.LookupDirectoryEntryRequest(
            directory=IAM_CONFIG_DIR, name=IAM_CONFIG_FILE),
        timeout=60).entry.content
    rpc.s3_stub(rpc.grpc_address(f"127.0.0.1:{sport}")).Configure(
        s3_pb2.S3ConfigureRequest(s3_configuration_file_content=doc),
        timeout=60)
    conn = http.client.HTTPConnection("127.0.0.1", sport, timeout=600)
    try:
        st, _ = _http(conn, "PUT", f"/{S3_BUCKET}/unsigned.bin", b"x")
        if st != 403:
            raise AssertionError(f"{phase}: an unsigned PUT answered {st}")
    finally:
        conn.close()
    cred_s = time.perf_counter() - t0

    # 2. objects by 8 clients, then the multipart ones at once
    small, large = _s3_objects(rng, len(files.payload))
    data = {key: memoryview(files.payload)[a:a + n]
            for key, a, n in small + large}

    def put(conn, key):
        body = bytes(data[key])
        st, said, r = s3.call(conn, "PUT", f"/{S3_BUCKET}/{key}", body)
        if st != 200 or r.getheader("ETag") != \
                f'"{hashlib.md5(body).hexdigest()}"':
            raise AssertionError(f"{phase}: PUT {key}: {st} {said[:300]!r}")

    t0 = time.perf_counter()
    _clients(sport, put, [k for k, _, _ in small])
    small_s = time.perf_counter() - t0

    def upload(item):
        key, a, n = item
        conn = http.client.HTTPConnection("127.0.0.1", sport, timeout=600)
        try:
            parts = [data[key][off:off + S3_PART]
                     for off in range(0, n, S3_PART)]
            return _s3_multipart(phase, s3, conn, key, parts), len(parts)
        finally:
            conn.close()

    t0 = time.perf_counter()
    completed = dict(zip([k for k, _, _ in large],
                         _all_at_once(upload, large)))
    large_s = time.perf_counter() - t0
    for key, (etag, nparts) in completed.items():
        want = f"{hashlib.md5(str(len(data[key])).encode()).hexdigest()}" \
               f"-{nparts}"
        if etag != want:
            raise AssertionError(f"{phase}: {key} completed with ETag "
                                 f"{etag}, not {want}")
    nbytes = sum(n for _, _, n in small + large)

    # 3. a paged ListObjectsV2 with a delimiter; a copy and a part copy
    conn = http.client.HTTPConnection("127.0.0.1", sport, timeout=600)
    try:
        t0 = time.perf_counter()
        st, body, _ = s3.call(conn, "GET", f"/{S3_BUCKET}?list-type=2"
                                           f"&delimiter=/")
        prefixes = [p.decode() for p in re.findall(
            rb"<CommonPrefixes><Prefix>([^<]+)</Prefix>", body)]
        listed, pages = [], 0
        for prefix in prefixes:
            token = ""
            while True:
                q = (f"/{S3_BUCKET}?list-type=2&delimiter=/&prefix={prefix}"
                     f"&max-keys={S3_PAGE}")
                if token:
                    q += f"&continuation-token={token}"
                st, body, _ = s3.call(conn, "GET", q)
                if st != 200:
                    raise AssertionError(f"{phase}: list {q}: {st}")
                pages += 1
                listed += [k.decode() for k in
                           re.findall(rb"<Key>([^<]+)</Key>", body)]
                m = re.search(rb"<NextContinuationToken>([^<]+)<", body)
                if b"<IsTruncated>true" not in body:
                    break
                if not m:
                    raise AssertionError(f"{phase}: {q} truncated with no "
                                         f"continuation token")
                token = m.group(1).decode()
        list_s = time.perf_counter() - t0
        if sorted(listed) != sorted(data):
            raise AssertionError(f"{phase}: the listing gave {len(listed)} "
                                 f"keys of {len(data)}")
        t0 = time.perf_counter()
        src0, src1 = large[0][0], large[1][0]
        st, body, _ = s3.call(conn, "PUT", f"/{S3_BUCKET}/copies/m0.bin",
                              headers={"x-amz-copy-source":
                                       f"/{S3_BUCKET}/{src0}"})
        if st != 200 or b"CopyObjectResult" not in body:
            raise AssertionError(f"{phase}: CopyObject: {st} {body[:300]!r}")
        _s3_multipart(phase, s3, conn, "upc/m1.bin", [f"/{S3_BUCKET}/{src1}"])
        data["copies/m0.bin"] = data[src0]
        data["upc/m1.bin"] = data[src1]
        for key in ("copies/m0.bin", "upc/m1.bin"):
            st, body, _ = s3.call(conn, "GET", f"/{S3_BUCKET}/{key}")
            if st != 200 or body != data[key]:
                raise AssertionError(f"{phase}: GET {key} after the copy: "
                                     f"{st}, {len(body)} B")
        copy_s = time.perf_counter() - t0
    finally:
        conn.close()

    # 4. the CLI's benchmark against the fleet's master
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "benchmark",
         "-master", fleet.master, "-n", str(BENCH_N), "-size",
         str(BENCH_SIZE), "-c", str(SERVER_CLIENTS), "-collection",
         BENCH_COLLECTION], cwd=HERE, env=fleet.env, capture_output=True,
        text=True, timeout=CLUSTER_CALL_S)
    bench_s = time.perf_counter() - t0
    w = re.search(r"write: ([\d.]+) req/s, ([\d.]+) MB/s, [\d.]+ s total, "
                  r"(\d+) failed", r.stdout)
    rd = re.search(r"read: ([\d.]+) req/s, [\d.]+ s total, (\d+) failed",
                   r.stdout)
    if r.returncode or not w or not rd or w.group(3) != "0" or \
            rd.group(2) != "0":
        raise AssertionError(f"{phase}: benchmark exited {r.returncode}:\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    lat = re.findall(r"latency: (.*)", r.stdout)
    log(phase, f"S3 gateway (`s3 -filer {faddr}`): shell -filer "
               f"s3.configure ({S3_ACTIONS}) and s3.bucket.create, the "
               f"identity pushed through SeaweedS3.Configure, an unsigned "
               f"PUT refused 403 ({cred_s:.2f} s); {len(small)} objects of "
               f"1-64 KiB over {S3_PREFIXES} prefixes PUT SigV4-signed by "
               f"{SERVER_CLIENTS} clients in {small_s:.3f} s "
               f"({len(small) / small_s:.0f} objects/s) and {len(large)} of "
               f"{S3_MULTIPART_MIB[0]}-{S3_MULTIPART_MIB[1]} MiB in "
               f"{S3_PART >> 20} MiB parts at once in "
               f"{large_s:.3f} s: {nbytes} B in {small_s + large_s:.3f} s "
               f"= {nbytes / (small_s + large_s) / 1e9:.3f} GB/s, "
               f"{(len(small) + len(large)) / (small_s + large_s):.0f} "
               f"objects/s; completed ETags md5(size)-parts; "
               f"ListObjectsV2 with delimiter / listed every key "
               f"({len(prefixes)} prefixes, {pages} pages of {S3_PAGE}, "
               f"{list_s:.3f} s); CopyObject of {src0} and an "
               f"UploadPartCopy of {src1} equal to their sources "
               f"({copy_s:.3f} s); benchmark -n {BENCH_N} -size "
               f"{BENCH_SIZE} -c {SERVER_CLIENTS}: write {w.group(1)} req/s "
               f"({w.group(2)} MB/s), read {rd.group(1)} req/s, 0 failed "
               f"({bench_s:.2f} s with the process start; latency "
               f"{'; '.join(lat)})")
    return dict(s3=s3, data=data, large=[k for k, _, _ in large],
                written=nbytes, write_s=small_s + large_s,
                objects=len(small) + len(large),
                bench=(float(w.group(1)), float(rd.group(1))))


def _s3_reads(phase: str, fleet: _Fleet, sport: int, faddr: str, s3w: dict,
              touching: set) -> dict:
    """Every S3 object GET through the gateway after the loss, byte-exact
    with its ETag; one Range GET across a part boundary; -> numbers."""
    s3, data = s3w["s3"], s3w["data"]
    etags = {}
    for d in ("mp", "upc"):
        for e in _filer_entries(faddr, f"/buckets/{S3_BUCKET}/{d}"):
            h = hashlib.md5()
            for c in e.chunks:
                h.update((c.e_tag or c.file_id).encode())
            etags[f"{d}/{e.name}"] = f"{h.hexdigest()}-{len(e.chunks)}"
    keys = sorted(data)

    def get(conn, key):
        t0 = time.perf_counter()
        st, body, r = s3.call(conn, "GET", f"/{S3_BUCKET}/{key}")
        dt = time.perf_counter() - t0
        if st != 200 or body != data[key]:
            raise AssertionError(f"{phase}: S3 GET {key}: {st}, "
                                 f"{len(body)} B, not the bytes written")
        want = etags.get(key) or hashlib.md5(body).hexdigest()
        if r.getheader("ETag") != f'"{want}"':
            raise AssertionError(f"{phase}: S3 GET {key}: ETag "
                                 f"{r.getheader('ETag')}, not {want}")
        return dt

    k0 = fleet.k1()
    got = _clients(sport, get, keys)
    k1 = fleet.k1()
    key = s3w["large"][0]
    a, b = S3_PART - 1000, S3_PART + 999
    conn = http.client.HTTPConnection("127.0.0.1", sport, timeout=600)
    try:
        st, body, r = s3.call(conn, "GET", f"/{S3_BUCKET}/{key}",
                              headers={"Range": f"bytes={a}-{b}"})
    finally:
        conn.close()
    if st != 206 or body != data[key][a:b + 1]:
        raise AssertionError(f"{phase}: S3 range GET of {key}: {st}")
    deg = [t for k, t in zip(keys, got)
           if f"/buckets/{S3_BUCKET}/{k}" in touching]
    rest = [t for k, t in zip(keys, got)
            if f"/buckets/{S3_BUCKET}/{k}" not in touching]
    reads_k1 = _k1_step(k0, k1)
    log(phase, f"every S3 object GET SigV4-signed through the gateway by "
               f"{SERVER_CLIENTS} readers, byte-exact with its ETag: "
               f"{len(keys)} in all ({_ms(got)}), {len(deg)} with a chunk "
               f"on a lost shard ({_ms(deg)}), {len(rest)} others "
               f"({_ms(rest)}); a Range GET of {key} across its first "
               f"part boundary byte-exact (206); K1 launches by R in these "
               f"reads {reads_k1}")
    if not deg or not reads_k1.get(4):
        raise AssertionError(f"{phase}: the S3 reads with a chunk on a "
                             f"lost shard ({len(deg)}) launched K1 by R "
                             f"{reads_k1}, none at R = 4")
    return dict(all=got, deg=deg, rest=rest, k1=reads_k1)


# -- the other gateways (webdav, ftp, iam, mq.broker, mount) -------------------

GW_FILES = 25  # files of 1-64 KiB through mount and through WebDAV
GW_DIRS = 6
GW_LARGE_MIB = 24  # one file through mount (past its 16 MiB budget), WebDAV
GW_FTP_FILES = 30
GW_FTP_LARGE_MIB = 16
GW_MOUNT_MEMORY_MB = 16
GW_PASSIVE = 40  # the FTP gateway's passive ports
GW_IAM_USER = "gw-user"
MQ_TOPIC = ("gw", "events")
MQ_RECORDS = 1_000  # of 100-1,000 B, half through gRPC, half through HTTP
MQ_PARTITIONS = 4
MQ_RING = 4096  # a segment's partition is one range of this ring
GW_NAMES = ("webdav", "ftp", "iam", "mq", "mount")


def _free_port_block(n: int, taken: list[int]) -> int:
    """The first of `n` consecutive free ports, none of them in `taken` or
    a gRPC twin of one."""
    twins = {p + d for p in taken for d in (0, 10000)}
    for _ in range(200):
        start = _free_port_pair()
        block = range(start, start + n)
        if start + n > 55000 or twins & set(block):
            continue
        try:
            for p in block:
                with socket.socket() as s:
                    s.bind(("", p))
        except OSError:
            continue
        return start
    raise RuntimeError("no free port block")


class _OsMount:
    """Files through a kernel mount: plain os calls on its mountpoint."""

    def __init__(self, mnt: str):
        self.mnt = mnt

    def mkdirs(self, path: str) -> None:
        os.makedirs(self.mnt + path, exist_ok=True)

    def write(self, path: str, data) -> None:
        with open(self.mnt + path, "wb") as f:
            f.write(data)

    def read(self, path: str) -> bytes:
        with open(self.mnt + path, "rb") as f:
            return f.read()

    def rename(self, old: str, new: str) -> None:
        os.rename(self.mnt + old, self.mnt + new)

    def symlink(self, target: str, path: str) -> None:
        os.symlink(target, self.mnt + path)

    def readlink(self, path: str) -> str:
        return os.readlink(self.mnt + path)

    def link(self, old: str, new: str) -> None:
        os.link(self.mnt + old, self.mnt + new)

    def setxattr(self, path: str, name: str, value: bytes) -> None:
        os.setxattr(self.mnt + path, name, value)

    def getxattr(self, path: str, name: str) -> bytes:
        return os.getxattr(self.mnt + path, name)

    def nlink(self, path: str) -> int:
        return os.stat(self.mnt + path).st_nlink


class _WfsMount:
    """The same calls in-process, through the path operations the FUSE
    callbacks make on a WFS (mount.PathOps), where this machine cannot
    mount; writes and reads in 128 KiB pieces, as the kernel sends
    them."""

    PIECE = 128 * 1024

    def __init__(self, wfs):
        from seaweedfs_tpu_torch.mount import FuseError, PathOps

        self.wfs = wfs
        self.ops = PathOps(wfs)
        self.FuseError = FuseError

    def mkdirs(self, path: str) -> None:
        parts = path.strip("/").split("/")
        for i in range(len(parts)):
            p = "/" + "/".join(parts[:i + 1])
            try:
                self.ops.mkdir(p, 0o755)
            except self.FuseError as e:
                if e.errno != errno.EEXIST:
                    raise

    def write(self, path: str, data) -> None:
        fh = self.ops.create(path, 0o644)
        try:
            for off in range(0, len(data), self.PIECE):
                self.ops.write(fh, off, bytes(data[off:off + self.PIECE]))
            self.ops.flush(fh)
        finally:
            self.ops.release(fh)

    def read(self, path: str) -> bytes:
        mode, size = self.ops.getattr(path)[:2]
        if stat.S_ISLNK(mode):  # followed, as the kernel follows it
            return self.read(os.path.join(os.path.dirname(path),
                                          self.ops.readlink(path)))
        fh = self.ops.open(path)
        try:
            return b"".join(self.ops.read(fh, off, self.PIECE)
                            for off in range(0, size, self.PIECE))
        finally:
            self.ops.release(fh)

    def rename(self, old: str, new: str) -> None:
        self.ops.rename(old, new)

    def symlink(self, target: str, path: str) -> None:
        self.ops.symlink(target, path)

    def readlink(self, path: str) -> str:
        return self.ops.readlink(path)

    def link(self, old: str, new: str) -> None:
        self.ops.link(old, new)

    def setxattr(self, path: str, name: str, value: bytes) -> None:
        self.ops.setxattr(path, name, value)

    def getxattr(self, path: str, name: str) -> bytes:
        return self.ops.getxattr(path, name)

    def nlink(self, path: str) -> int:
        return self.ops.getattr(path)[3]


class _Gateways:
    """The phase's other gateways over its filer: `webdav`, `ftp`, `iam`
    and `mq.broker` processes, and the mount: a `mount` process where
    this machine can mount (/dev/fuse, libfuse.so.2), else a WFS in this
    process with its control socket, so that `mount.configure` reaches it
    either way."""

    def __init__(self, fleet: _Fleet, root: str, faddr: str):
        from seaweedfs_tpu_torch.mount import fuse_binding

        self.fleet = fleet
        self.root = root
        self.faddr = faddr
        self.modules = {}
        self.missing = fuse_binding.fuse_missing()
        self.kernel = not [m for m in self.missing if m in
                           ("/dev/fuse", "libfuse.so.2")]
        taken = fleet.ports() + [fleet.master_port]
        self.port = {}
        for name in ("webdav", "iam", "mq", "ftp"):
            p = _free_port_pair()
            while p in taken:
                p = _free_port_pair()
            taken.append(p)
            self.port[name] = p
        self.passive = _free_port_block(GW_PASSIVE, taken)
        args = {
            "webdav": ["webdav", "-port", str(self.port["webdav"]),
                       "-filer", faddr],
            "ftp": ["ftp", "-port", str(self.port["ftp"]), "-filer", faddr,
                    "-ip", "127.0.0.1", "-portRangeStart", str(self.passive),
                    "-portRangeStop", str(self.passive + GW_PASSIVE)],
            "iam": ["iam", "-port", str(self.port["iam"]), "-filer", faddr],
            "mq": ["mq.broker", "-port", str(self.port["mq"]), "-filer",
                   faddr],
        }
        for name, a in args.items():
            self.spawn(name, a, self.port[name])
        self.mnt = os.path.join(root, "mnt")
        os.mkdir(self.mnt)
        self.wfs = self.control = self.fs = None
        if self.kernel:
            self.spawn_mount("mount", self.mnt)

    def spawn(self, name: str, args: list, port: int) -> None:
        self.modules[name] = os.path.join(self.root, f"{name}.modules")
        self.fleet._spawn(name, args, port, "", modules=self.modules[name])

    def spawn_mount(self, name: str, mnt: str) -> None:
        self.spawn(name, ["mount", "-filer", self.faddr, "-dir", mnt,
                          "-collection", FILER_COLLECTION,
                          "-memoryLimitMB", str(GW_MOUNT_MEMORY_MB),
                          "-localPort", str(_free_port_pair())], 0)
        self.fs = _OsMount(mnt)

    def in_process(self, mnt: str, control: bool = False) -> _WfsMount:
        from seaweedfs_tpu_torch.mount import WFS
        from seaweedfs_tpu_torch.mount.control import MountControlServer

        self.close_in_process()
        self.wfs = WFS(rpc.grpc_address(self.faddr),
                       collection=FILER_COLLECTION,
                       memory_limit_mb=GW_MOUNT_MEMORY_MB)
        if control:
            self.control = MountControlServer(self.wfs, mount_dir=mnt)
            self.control.start()
        return _WfsMount(self.wfs)

    def close(self) -> None:
        """Unmount what a failed run left mounted, before the processes
        are killed and the directory removed."""
        from seaweedfs_tpu_torch.mount import fuse_binding

        self.close_in_process()
        for mnt in (self.mnt, os.path.join(self.root, "mnt2")):
            if os.path.ismount(mnt):
                fuse_binding.unmount(mnt)

    def close_in_process(self) -> None:
        if self.control is not None:
            self.control.stop()
            self.control = None
        if self.wfs is not None:
            self.wfs.close()
            self.wfs = None

    def wait_up(self, names, timeout: float = SERVER_START_S) -> None:
        """Until each gateway answers: WebDAV's OPTIONS, FTP's greeting,
        IAM's POST, the broker's gRPC port and topic list, a mounted
        mountpoint."""
        t0 = time.perf_counter()

        def ready(name) -> bool:
            if name.startswith("mount"):
                return os.path.ismount(self.fs.mnt)
            port = self.port[name]
            kind = name.rstrip("0123456789")
            if kind == "ftp":
                with socket.create_connection(("127.0.0.1", port),
                                              timeout=5) as s:
                    return s.recv(64).startswith(b"220")
            if kind == "mq":  # its gRPC listener starts after the HTTP one
                socket.create_connection(
                    ("127.0.0.1", rpc.derived_grpc_port(port)),
                    timeout=5).close()
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            try:
                method, path = {"webdav": ("OPTIONS", "/"),
                                "iam": ("POST", "/"),
                                "mq": ("GET", "/topics")}[kind]
                conn.request(method, path, body=b"" if method == "POST"
                             else None)
                return conn.getresponse().status < 500
            finally:
                conn.close()

        for name in names:
            proc = self.fleet.procs[name][0]
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"{self.fleet.phase}: {name} "
                                         f"exited with {proc.returncode} "
                                         f"at start")
                try:
                    if ready(name):
                        break
                except OSError:
                    pass
                if time.perf_counter() - t0 > timeout:
                    raise AssertionError(f"{self.fleet.phase}: {name} not "
                                         f"up in {timeout} s")
                time.sleep(0.1)

    def stop(self, name: str, sig=signal.SIGINT) -> float:
        """`sig` to one gateway: it must exit 0 with neither jax nor
        seaweedfs_tpu in its sys.modules; -> seconds to exit."""
        proc = self.fleet.procs[name][0]
        t0 = time.perf_counter()
        proc.send_signal(sig)
        rc = proc.wait(timeout=120)
        dt = time.perf_counter() - t0
        self.check_modules(name, rc)
        return dt

    def check_modules(self, name: str, rc: int) -> None:
        with open(self.modules[name]) as f:
            mods = f.read().split("\n")
        jax_mods = [m for m in mods if m in ("jax", "seaweedfs_tpu")
                    or m.startswith(("jax.", "seaweedfs_tpu."))]
        if rc != 0 or jax_mods or not [m for m in mods if m.startswith(
                "seaweedfs_tpu_torch.")]:
            raise AssertionError(f"{self.fleet.phase}: {name} exited {rc}; "
                                 f"jax or seaweedfs_tpu modules {jax_mods}")


def _gw_set(rng, payload_len: int, top: str, n: int, large_mib: int,
            dirs: int) -> dict[str, tuple[int, int]]:
    """{path: (start, size)} under `top`: `n` files of 1-64 KiB in `dirs`
    directories and one of `large_mib` MiB, slices of the payload."""
    out = {}
    for i in range(n):
        size = int(rng.integers(1, 64 * 1024 + 1))
        out[f"{top}/d{i % dirs}/f{i:04d}"] = (
            int(rng.integers(0, payload_len - size)), size)
    size = large_mib * MIB
    out[f"{top}/large.bin"] = (int(rng.integers(0, payload_len - size)),
                               size)
    return out


def _sign(method: str, url: str, body: bytes, key: tuple) -> dict:
    from seaweedfs_tpu_torch.s3api import sigv4_client

    return sigv4_client.sign_request(method, url, body, key[0], key[1])


def _mount_writes(phase: str, gw: _Gateways, files: _FilerFiles, rng
                  ) -> dict:
    """Through the mount: the small files and the large one, a rename, a
    symlink, a hard link, an xattr; the quota from `mount.configure`."""
    fs = gw.fs
    items = _gw_set(rng, len(files.payload), "/gw/mnt", GW_FILES,
                    GW_LARGE_MIB, GW_DIRS)
    t0 = time.perf_counter()
    for d in sorted({p.rsplit("/", 1)[0] for p in items}):
        fs.mkdirs(d)

    def write(p):
        a, n = items[p]
        fs.write(p, memoryview(files.payload)[a:a + n])

    _in_threads(write, sorted(items))
    write_s = time.perf_counter() - t0
    renamed = "/gw/mnt/d0/f0000"
    items["/gw/mnt/renamed"] = items.pop(renamed)
    fs.rename(renamed, "/gw/mnt/renamed")
    fs.symlink("renamed", "/gw/mnt/symlink")
    fs.link("/gw/mnt/large.bin", "/gw/mnt/hard.bin")
    items["/gw/mnt/hard.bin"] = items["/gw/mnt/large.bin"]
    fs.setxattr("/gw/mnt/renamed", "user.smoke", b"gateway step")
    a, n = items["/gw/mnt/renamed"]
    # the new link's attributes (the kernel may hold the first name's for
    # its attribute timeout)
    checks = {"symlink": fs.readlink("/gw/mnt/symlink") == "renamed",
              "through the symlink": fs.read("/gw/mnt/symlink")
              == files.payload[a:a + n],
              "hard link": fs.nlink("/gw/mnt/hard.bin") == 2,
              "xattr": fs.getxattr("/gw/mnt/renamed", "user.smoke")
              == b"gateway step"}
    if not all(checks.values()):
        raise AssertionError(f"{phase}: through the mount {checks}")
    t0 = time.perf_counter()
    bad = [p for p, same in zip(sorted(items), _in_threads(
        lambda p: fs.read(p) == files.payload[items[p][0]:sum(items[p])],
        sorted(items))) if not same]
    read_s = time.perf_counter() - t0
    if bad:
        raise AssertionError(f"{phase}: {len(bad)} files read back through "
                             f"the mount differ, e.g. {bad[0]}")
    # the quota, set and lifted by the shell's mount.configure
    out, _ = gw.fleet.shell(f"mount.configure -dir={gw.mnt} -quotaMB=1",
                            filer=gw.faddr)
    if f"quota 1 MB set on the mount at {gw.mnt}" not in out:
        raise AssertionError(f"{phase}: mount.configure said:\n{out}")
    fs.mkdirs("/gw/mnt/quota")
    try:
        fs.write("/gw/mnt/quota/over.bin", b"x" * 100_000)
        refused = None
    except OSError as e:
        refused = e.errno
    if refused != errno.ENOSPC:
        raise AssertionError(f"{phase}: a write past the quota gave "
                             f"{refused}, not ENOSPC")
    gw.fleet.shell(f"mount.configure -dir={gw.mnt} -quotaMB=0",
                   filer=gw.faddr)
    fs.write("/gw/mnt/quota/after.bin",
             files.payload[:100_000])
    items["/gw/mnt/quota/after.bin"] = (0, 100_000)
    nbytes = sum(n for _, n in items.values())
    log(phase, f"mount ({'a kernel mount: `mount -filer` process' if gw.kernel else 'in-process WFS through the FUSE path operations'}, "
               f"-collection {FILER_COLLECTION}, -memoryLimitMB "
               f"{GW_MOUNT_MEMORY_MB}): {GW_FILES} files of 1-64 KiB in "
               f"{GW_DIRS} directories and one of {GW_LARGE_MIB} MiB "
               f"written by {SERVER_CLIENTS} writers in {write_s:.3f} s "
               f"({nbytes / write_s / 1e9:.3f} GB/s); a rename, a symlink, "
               f"a hard link (nlink 2) and a user xattr read back; every "
               f"file read back byte-exact by {SERVER_CLIENTS} readers in "
               f"{read_s:.3f} s; `mount.configure -quotaMB=1` through shell "
               f"-filer: a write past it ENOSPC, `-quotaMB=0` lifts it")
    return dict(items=items, write_s=write_s)


def _dav_writes(phase: str, gw: _Gateways, files: _FilerFiles, rng
                ) -> dict:
    """Through WebDAV: the small files by 8 clients, the large one as a
    chunked PUT; PROPFIND of each directory; MKCOL, MOVE, COPY; a LOCK
    that refuses a PUT without its token, UNLOCK."""
    port = gw.port["webdav"]
    items = _gw_set(rng, len(files.payload), "/gw/dav", GW_FILES,
                    GW_LARGE_MIB, GW_DIRS)
    paths = sorted(items)

    def put(conn, path):
        a, n = items[path]
        st, body = _http(conn, "PUT", path,
                         bytes(memoryview(files.payload)[a:a + n]))
        if st != 201:
            raise AssertionError(f"{phase}: WebDAV PUT {path}: {st}")

    t0 = time.perf_counter()
    _clients(port, put, [p for p in paths if items[p][1] <= 64 * 1024])
    small_s = time.perf_counter() - t0
    a, n = items["/gw/dav/large.bin"]
    big = memoryview(files.payload)[a:a + n]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("PUT", "/gw/dav/large.bin", encode_chunked=True,
                     body=(bytes(big[o:o + MIB]) for o in range(0, n, MIB)),
                     headers={"Transfer-Encoding": "chunked"})
        r = conn.getresponse()
        r.read()
        large_s = time.perf_counter() - t0
        if r.status != 201:
            raise AssertionError(f"{phase}: WebDAV chunked PUT: {r.status}")
        dirs = sorted({p.rsplit("/", 1)[0] for p in paths})
        for d in dirs:
            conn.request("PROPFIND", d, headers={"Depth": "1"})
            r = conn.getresponse()
            body = r.read()
            hrefs = set(re.findall(rb"<ns0:href>([^<]+)</ns0:href>", body))
            want = {p.encode() for p in paths if p.rsplit("/", 1)[0] == d}
            if r.status != 207 or not want <= hrefs:
                raise AssertionError(f"{phase}: PROPFIND {d}: {r.status}, "
                                     f"{len(want - hrefs)} files missing")
        steps = [("MKCOL", "/gw/dav/made", {}, 201),
                 ("MOVE", "/gw/dav/d0/f0000",
                  {"Destination": f"http://127.0.0.1:{port}/gw/dav/made/m"},
                  201),
                 ("COPY", "/gw/dav/d1/f0001",
                  {"Destination": f"http://127.0.0.1:{port}/gw/dav/made/c"},
                  201)]
        for method, path, headers, want in steps:
            conn.request(method, path, headers=headers)
            r = conn.getresponse()
            r.read()
            if r.status != want:
                raise AssertionError(f"{phase}: WebDAV {method} {path}: "
                                     f"{r.status}")
    finally:
        conn.close()
    items["/gw/dav/made/m"] = items.pop("/gw/dav/d0/f0000")
    items["/gw/dav/made/c"] = items["/gw/dav/d1/f0001"]
    # a LOCK refuses a PUT without its token (the 423 closes the
    # connection, so each request has its own)
    lockinfo = (b'<?xml version="1.0"?><D:lockinfo xmlns:D="DAV:">'
                b'<D:lockscope><D:exclusive/></D:lockscope><D:locktype>'
                b'<D:write/></D:locktype><D:owner>smoke</D:owner>'
                b'</D:lockinfo>')
    said = []
    for method, body, headers in (
            ("LOCK", lockinfo, {"Timeout": "Second-60"}),
            ("PUT", b"no token", {}), ("UNLOCK", None, None),
            ("PUT", b"after unlock", {})):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            if method == "UNLOCK":
                headers = {"Lock-Token": token}
            conn.request(method, "/gw/dav/locked.txt", body=body,
                         headers=headers)
            r = conn.getresponse()
            r.read()
            said.append(r.status)
            if method == "LOCK":
                token = r.getheader("Lock-Token")
        finally:
            conn.close()
    if said != [200, 423, 204, 201]:
        raise AssertionError(f"{phase}: WebDAV LOCK, PUT without the "
                             f"token, UNLOCK, PUT answered {said}")
    log(phase, f"WebDAV (`webdav -filer`): {GW_FILES} files of 1-64 KiB "
               f"PUT by {SERVER_CLIENTS} clients in {small_s:.3f} s "
               f"({GW_FILES / small_s:.0f} files/s), one of "
               f"{GW_LARGE_MIB} MiB as a chunked PUT in {large_s:.3f} s "
               f"({n / large_s / 1e9:.3f} GB/s); PROPFIND Depth 1 of its "
               f"{len(dirs)} directories lists every file; MKCOL, MOVE, "
               f"COPY 201; LOCK 200, a PUT without its token 423, UNLOCK "
               f"204, the PUT then 201")
    return dict(items=items)


def _ftp_writes(phase: str, gw: _Gateways, files: _FilerFiles, rng
                ) -> dict:
    """Through FTP in passive mode: the small files and the large one;
    LIST."""
    import ftplib
    import io

    items = _gw_set(rng, len(files.payload), "/gw/ftp", GW_FTP_FILES,
                    GW_FTP_LARGE_MIB, 1)
    ftp = ftplib.FTP()
    ftp.connect("127.0.0.1", gw.port["ftp"], timeout=120)
    try:
        ftp.login("smoke", "smoke")
        ftp.mkd("/gw/ftp")
        ftp.mkd("/gw/ftp/d0")
        t0 = time.perf_counter()
        for p, (a, n) in items.items():
            ftp.storbinary(f"STOR {p}", io.BytesIO(
                memoryview(files.payload)[a:a + n]), blocksize=MIB)
        write_s = time.perf_counter() - t0
        lines = []
        ftp.retrlines("LIST /gw/ftp/d0", lines.append)
        names = sorted(ln.rsplit(" ", 1)[1] for ln in lines)
        want = sorted(p.rsplit("/", 1)[1] for p in items
                      if p.startswith("/gw/ftp/d0/"))
        if names != want:
            raise AssertionError(f"{phase}: FTP LIST gave {len(names)} "
                                 f"names, not {len(want)}")
        ftp.quit()
    finally:
        ftp.close()
    nbytes = sum(n for _, n in items.values())
    log(phase, f"FTP (`ftp -filer`, passive ports {gw.passive}-"
               f"{gw.passive + GW_PASSIVE - 1}): {GW_FTP_FILES} files of "
               f"1-64 KiB and one of {GW_FTP_LARGE_MIB} MiB STOR in "
               f"{write_s:.3f} s ({nbytes / write_s / 1e9:.3f} GB/s); LIST "
               f"gives every name")
    return dict(items=items)


def _iam_step(phase: str, gw: _Gateways, sport: int, s3w: dict) -> dict:
    """IAM, every call SigV4-signed by the S3 step's Admin identity: a
    user, its key and a policy; the S3 gateway takes the new identity
    through SeaweedS3.Configure and accepts the key, then refuses it
    once the key is deleted."""
    from seaweedfs_tpu_torch.iamapi import IAM_CONFIG_DIR, IAM_CONFIG_FILE
    from seaweedfs_tpu_torch.pb import filer_pb2, s3_pb2

    url = f"http://127.0.0.1:{gw.port['iam']}/"
    admin = S3_IDENTITY[1:]
    t0 = time.perf_counter()

    def iam(**params):
        body = urllib.parse.urlencode(params).encode()
        h = {"Content-Type": "application/x-www-form-urlencoded"}
        h.update(_sign("POST", url, body, admin))
        conn = http.client.HTTPConnection("127.0.0.1", gw.port["iam"],
                                          timeout=60)
        try:
            conn.request("POST", "/", body=body, headers=h)
            r = conn.getresponse()
            out = r.read()
        finally:
            conn.close()
        if r.status != 200:
            raise AssertionError(f"{phase}: IAM {params['Action']}: "
                                 f"{r.status} {out[:300]!r}")
        return out

    def push():
        doc = rpc.filer_stub(rpc.grpc_address(gw.faddr)).LookupDirectoryEntry(
            filer_pb2.LookupDirectoryEntryRequest(
                directory=IAM_CONFIG_DIR, name=IAM_CONFIG_FILE),
            timeout=60).entry.content
        rpc.s3_stub(rpc.grpc_address(f"127.0.0.1:{sport}")).Configure(
            s3_pb2.S3ConfigureRequest(s3_configuration_file_content=doc),
            timeout=60)

    iam(Action="CreateUser", UserName=GW_IAM_USER)
    out = iam(Action="CreateAccessKey", UserName=GW_IAM_USER)
    key = (re.search(rb"<AccessKeyId>([^<]+)<", out).group(1).decode(),
           re.search(rb"<SecretAccessKey>([^<]+)<", out).group(1).decode())
    iam(Action="PutUserPolicy", UserName=GW_IAM_USER, PolicyName="smoke",
        PolicyDocument=json.dumps({"Version": "2012-10-17", "Statement": [{
            "Effect": "Allow", "Action": ["s3:GetObject", "s3:PutObject",
                                          "s3:ListBucket"],
            "Resource": [f"arn:aws:s3:::{S3_BUCKET}/*"]}]}))
    listed = iam(Action="ListUsers")
    if f"<UserName>{GW_IAM_USER}</UserName>".encode() not in listed or \
            f"<UserName>{S3_IDENTITY[0]}</UserName>".encode() not in listed:
        raise AssertionError(f"{phase}: IAM ListUsers: {listed[:500]!r}")
    push()
    obj = f"/{S3_BUCKET}/iam/by-new-key.bin"
    body = b"written with a key minted through IAM"

    def s3(method: str, data: bytes, k: tuple) -> tuple[int, bytes]:
        conn = http.client.HTTPConnection("127.0.0.1", sport, timeout=60)
        try:
            conn.request(method, obj, body=data or None, headers=_sign(
                method, f"http://127.0.0.1:{sport}{obj}", data, k))
            r = conn.getresponse()
            return r.status, r.read()
        finally:
            conn.close()

    put = s3("PUT", body, key)
    got = s3("GET", b"", key)
    if put[0] != 200 or got != (200, body):
        raise AssertionError(f"{phase}: S3 with the IAM key: PUT {put[0]}, "
                             f"GET {got[0]}")
    iam(Action="DeleteAccessKey", UserName=GW_IAM_USER, AccessKeyId=key[0])
    push()
    refused = s3("PUT", b"after the key was deleted", key)[0]
    if refused != 403:
        raise AssertionError(f"{phase}: S3 with the deleted key: {refused}")
    s3w["data"][obj.split("/", 2)[2]] = body
    log(phase, f"IAM (`iam -filer`), every call SigV4-signed by "
               f"{S3_IDENTITY[0]} (Admin): CreateUser, CreateAccessKey, "
               f"PutUserPolicy (Read,Write,List on {S3_BUCKET}), ListUsers "
               f"lists both; identity.json pushed through "
               f"SeaweedS3.Configure: a PUT and a GET signed with the new "
               f"key 200; DeleteAccessKey and a push: a PUT signed with "
               f"it 403 ({time.perf_counter() - t0:.2f} s)")
    return dict(key=key)


def _mq_records(rng) -> list[tuple[bytes, bytes]]:
    """(key, value) of each record: 100-1,000 printable bytes, each value
    unique (its sequence number first)."""
    out = []
    for i in range(MQ_RECORDS):
        n = int(rng.integers(100, 1001))
        fill = rng.integers(97, 123, n, dtype=np.uint8).tobytes()
        value = (f"{i:05d}:".encode() + fill)[:n]
        out.append((f"k{int(rng.integers(0, 1000)):03d}".encode(), value))
    return out


def _mq_read(port: int) -> list[list[tuple]]:
    """Every partition of the topic from offset 0 through the broker's
    gRPC Subscribe: [(offset, key, value, ts_ns)] in each."""
    import grpc

    from seaweedfs_tpu_torch.pb import mq_pb2

    # a channel of its own: a cached one to a restarted broker's address
    # sits in reconnect backoff
    addr = f"127.0.0.1:{rpc.derived_grpc_port(port)}"
    out = []
    with grpc.insecure_channel(addr) as ch:
        stub = rpc.Stub(ch, rpc.MQ_SERVICE, addr)
        for pid in range(MQ_PARTITIONS):
            seg = mq_pb2.Segment(namespace=MQ_TOPIC[0], topic=MQ_TOPIC[1],
                                 id=pid)
            out.append([(r.offset, r.key, r.message, r.ts_ns)
                        for r in stub.Subscribe(mq_pb2.SubscribeRequest(
                            segment=seg, start_offset=0,
                            max_records=1 << 30), timeout=300)])
    return out


def _mq_step(phase: str, gw: _Gateways, rng) -> dict:
    """MQ: a topic of 4 partitions, half the records through the broker's
    gRPC Publish stream and half through its HTTP API by 8 clients; a
    subscription from offset 0 returns them in order; the broker stopped
    (SIGINT: its flush to the filer), `mq.topic.list`, a new broker
    started: the same records."""
    from seaweedfs_tpu_torch.pb import mq_pb2

    port = gw.port["mq"]
    records = _mq_records(rng)
    half = MQ_RECORDS // 2
    part = mq_pb2.Partition(ring_size=MQ_RING, range_start=0,
                            range_stop=MQ_RING // MQ_PARTITIONS)
    seg = mq_pb2.Segment(namespace=MQ_TOPIC[0], topic=MQ_TOPIC[1],
                         partition=part)
    stub = rpc.mq_stub(f"127.0.0.1:{rpc.derived_grpc_port(port)}")
    t0 = time.perf_counter()
    stub.AssignSegmentBrokers(mq_pb2.AssignSegmentBrokersRequest(
        segment=seg), timeout=60)

    def reqs():
        yield mq_pb2.PublishRequest(init=mq_pb2.PublishRequest.InitMessage(
            segment=seg))
        for key, value in records[:half]:
            yield mq_pb2.PublishRequest(key=key, message=value)

    acks = [r for r in stub.Publish(reqs(), timeout=600)]
    if len(acks) != half or any(r.error for r in acks):
        raise AssertionError(f"{phase}: MQ Publish acked {len(acks)} of "
                             f"{half}")
    grpc_s = time.perf_counter() - t0
    path = f"/topics/{MQ_TOPIC[0]}/{MQ_TOPIC[1]}"

    def post(conn, rec):
        key, value = rec
        conn.request("POST", path, body=value,
                     headers={"X-Mq-Key": key.decode()})
        r = conn.getresponse()
        said = json.loads(r.read())
        if r.status != 200 or "offset" not in said:
            raise AssertionError(f"{phase}: MQ POST: {r.status} {said}")

    t0 = time.perf_counter()
    _clients(port, post, records[half:])
    http_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    parts = _mq_read(port)
    read_s = time.perf_counter() - t0
    by_value = {v: k for k, v in records}
    got = [(r[1], r[2]) for p in parts for r in p]
    order = {v: i for i, (_, v) in enumerate(records[:half])}
    if sorted(got) != sorted(records) or any(
            [r[0] for r in p] != list(range(len(p))) for p in parts) or any(
            by_value[v] != k for k, v in got) or min(map(len, parts)) == 0:
        raise AssertionError(f"{phase}: the MQ subscription did not return "
                             f"the {MQ_RECORDS} records published")
    for p in parts:  # the gRPC stream's records keep their publish order
        seq = [order[r[2]] for r in p if r[2] in order]
        if seq != sorted(seq):
            raise AssertionError(f"{phase}: a partition returned the "
                                 f"published records out of order")
    stop_s = gw.stop("mq")
    out, _ = gw.fleet.shell("mq.topic.list", filer=gw.faddr)
    listed = f"{MQ_TOPIC[0]}.{MQ_TOPIC[1]} partitions={MQ_PARTITIONS}"
    if listed not in out:
        raise AssertionError(f"{phase}: mq.topic.list said:\n{out}")
    t0 = time.perf_counter()
    gw.spawn("mq2", ["mq.broker", "-port", str(port), "-filer", gw.faddr],
             port)
    gw.port["mq2"] = port
    gw.wait_up(["mq2"])
    restart_s = time.perf_counter() - t0
    again = _mq_read(port)
    if again != parts:
        raise AssertionError(f"{phase}: after the broker's restart the "
                             f"topic returned other records")
    nbytes = sum(len(v) for _, v in records)
    log(phase, f"MQ (`mq.broker -filer`): topic {MQ_TOPIC[0]}.{MQ_TOPIC[1]}"
               f" of {MQ_PARTITIONS} partitions (a segment's range of "
               f"{MQ_RING // MQ_PARTITIONS} of a {MQ_RING}-slot ring); "
               f"{half} records of 100-1,000 B through one gRPC Publish "
               f"stream in {grpc_s:.3f} s ({half / grpc_s:.0f}/s), "
               f"{MQ_RECORDS - half} through HTTP POST by {SERVER_CLIENTS} "
               f"clients in {http_s:.3f} s "
               f"({(MQ_RECORDS - half) / http_s:.0f}/s), {nbytes} B; a gRPC "
               f"Subscribe of each partition from offset 0 returned all "
               f"{MQ_RECORDS} in order ({[len(p) for p in parts]} by "
               f"partition, {read_s:.3f} s); SIGINT: exit 0 in "
               f"{stop_s:.2f} s with its flush to the filer; shell -filer "
               f"mq.topic.list \"{listed}\"; a new broker up in "
               f"{restart_s:.2f} s returns the same records, offsets and "
               f"timestamps. The segments are inline filer entries: none "
               f"reaches a volume server, none is erasure-coded")
    return dict(records=MQ_RECORDS)


def _gateway_writes(phase: str, gw: _Gateways, files: _FilerFiles, rng,
                    sport: int, s3w: dict) -> dict:
    """The gateways' step before the encode; -> what the reads after the
    loss need."""
    t0 = time.perf_counter()
    if gw.kernel:
        log(phase, "mount: /dev/fuse and libfuse.so.2 are present: a "
                   "kernel mount (`mount` process; the shim built with "
                   "gcc at its first mount)")
    else:
        log(phase, f"mount: this machine lacks {' and '.join(gw.missing)}:"
                   f" no kernel mount; the step drives the same WFS "
                   f"operations in this process, through the path "
                   f"operations the FUSE callbacks make")
        gw.fs = gw.in_process(gw.mnt, control=True)
    out = dict(mount=_mount_writes(phase, gw, files, rng),
               dav=_dav_writes(phase, gw, files, rng),
               ftp=_ftp_writes(phase, gw, files, rng),
               iam=_iam_step(phase, gw, sport, s3w),
               mq=_mq_step(phase, gw, rng))
    if gw.kernel:
        dt = gw.stop("mount")
        log(phase, f"mount SIGINT: unmounted, exit 0 in {dt:.2f} s, no jax "
                   f"or seaweedfs_tpu in its sys.modules")
    else:
        gw.close_in_process()
    out["write_s"] = time.perf_counter() - t0
    return out


def _gateway_reads(phase: str, gw: _Gateways, files: _FilerFiles,
                   gwr: dict, touching: set) -> dict:
    """After the SIGKILL: every file read back through a new mount (its
    chunk cache cold), through WebDAV (GET, and a Range GET) and through
    FTP (RETR), byte for byte; -> ms by gateway, split by the loss."""
    import ftplib

    fleet = gw.fleet
    t_step = time.perf_counter()
    k0 = fleet.k1()
    mnt2 = os.path.join(gw.root, "mnt2")
    os.mkdir(mnt2)
    t0 = time.perf_counter()
    if gw.kernel:
        gw.spawn_mount("mount2", mnt2)
        gw.wait_up(["mount2"])
    else:
        gw.fs = gw.in_process(mnt2)
    up_s = time.perf_counter() - t0
    ms: dict[str, dict[str, list]] = {}

    def timed(name: str, path: str, fn):
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        ms.setdefault(name, {"deg": [], "rest": []})[
            "deg" if path in touching else "rest"].append(dt)

    def want(items, path):
        a, n = items[path]
        return files.payload[a:a + n]

    items = gwr["mount"]["items"]

    def mount_read(p):
        t0 = time.perf_counter()
        if gw.fs.read(p) != want(items, p):
            raise AssertionError(f"{phase}: {p} through the new mount is "
                                 f"not the bytes written")
        return time.perf_counter() - t0

    mount_paths = sorted(items)
    for p, dt in zip(mount_paths, _in_threads(mount_read, mount_paths)):
        ms.setdefault("mount", {"deg": [], "rest": []})[
            "deg" if p in touching else "rest"].append(dt)
    if gw.fs.readlink("/gw/mnt/symlink") != "renamed" or \
            gw.fs.getxattr("/gw/mnt/renamed", "user.smoke") != \
            b"gateway step":
        raise AssertionError(f"{phase}: the symlink or the xattr did not "
                             f"survive")
    if gw.kernel:
        gw.stop("mount2")
    else:
        gw.close_in_process()

    items = gwr["dav"]["items"]

    def dav_get(conn, p):
        t0 = time.perf_counter()
        st, body = _http(conn, "GET", p)
        dt = time.perf_counter() - t0
        if st != 200 or body != want(items, p):
            raise AssertionError(f"{phase}: WebDAV GET {p}: {st}")
        return dt

    dav_paths = sorted(items)
    for p, dt in zip(dav_paths, _clients(gw.port["webdav"], dav_get,
                                         dav_paths)):
        ms.setdefault("webdav", {"deg": [], "rest": []})[
            "deg" if p in touching else "rest"].append(dt)
    conn = http.client.HTTPConnection("127.0.0.1", gw.port["webdav"],
                                      timeout=600)
    try:
        a, b = 4 * MIB - 1000, 4 * MIB + 999
        conn.request("GET", "/gw/dav/large.bin",
                     headers={"Range": f"bytes={a}-{b}"})
        r = conn.getresponse()
        body = r.read()
    finally:
        conn.close()
    if r.status != 206 or body != want(items, "/gw/dav/large.bin")[a:b + 1]:
        raise AssertionError(f"{phase}: WebDAV Range GET: {r.status}")

    items = gwr["ftp"]["items"]
    ftp = ftplib.FTP()
    ftp.connect("127.0.0.1", gw.port["ftp"], timeout=600)
    try:
        ftp.login("smoke", "smoke")
        for p in sorted(items):
            def retr(p=p):
                buf = bytearray()
                ftp.retrbinary(f"RETR {p}", buf.extend, blocksize=MIB)
                if bytes(buf) != want(items, p):
                    raise AssertionError(f"{phase}: FTP RETR {p} is not "
                                         f"the bytes written")
            timed("ftp", p, retr)
        ftp.quit()
    finally:
        ftp.close()
    k1 = fleet.k1()
    reads_k1 = _k1_step(k0, k1)
    said = "; ".join(
        f"{name} {len(v['deg']) + len(v['rest'])} files: "
        f"{len(v['deg'])} with a chunk on a lost shard ({_ms(v['deg'])}), "
        f"{len(v['rest'])} others ({_ms(v['rest'])})"
        for name, v in ms.items())
    log(phase, f"after the SIGKILL, every gateway file read back byte for "
               f"byte: through a new mount by {SERVER_CLIENTS} readers "
               f"({'process' if gw.kernel else 'in-process WFS'}, its "
               f"chunk cache cold, up in {up_s:.2f} s; the symlink and the "
               f"xattr kept), WebDAV GET by {SERVER_CLIENTS} "
               f"readers and a Range GET across a chunk boundary (206), "
               f"FTP RETR: {said}; K1 launches by R in these reads "
               f"{reads_k1} ({time.perf_counter() - t_step:.2f} s)")
    if not reads_k1.get(4) or not all(v["deg"] for v in ms.values()):
        raise AssertionError(f"{phase}: the gateways' reads with a chunk on "
                             f"a lost shard launched K1 by R {reads_k1}, or "
                             f"some gateway read none ({ms.keys()})")
    return dict(ms=ms, k1=reads_k1)


FT_FILES = 150  # files of 1-64 KiB PUT to filer A's /sync by 8 clients
FT_DIRS = 4
FT_LARGE_MIB = 24  # one file of /sync, one of the remote
FT_B_FILES = 20  # files written on filer B's /sync
FT_COPY_FILES = 50  # a local directory through filer.copy
FT_REMOTE_FILES = 100  # files of 1-64 KiB on the local-directory remote
FT_READ_THROUGH = 20  # of them read through before remote.cache
FT_UNCACHE = 10
FT_CHANGED = 5
FT_TOPIC = "seaweedfs_filer"
FT_PARTITIONS = 3
FT_IDLE_S = 3.0  # a metadata stream idle this long has nothing more
FT_CONVERGE_S = 300
FT_TOOLS = ("filer.sync", "filer.replicate", "filer.meta.tail",
            "filer.meta.backup")


def _test_module(name: str):
    """tests/<name>.py loaded by its file path (the fakes import only the
    standard library; neither tests/__init__.py nor conftest.py runs)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fake_kafka_broker():
    """tests/fake_kafka.py's FakeKafkaBroker, loaded by its file path."""
    return _test_module("fake_kafka").FakeKafkaBroker(
        topic=FT_TOPIC, partitions=FT_PARTITIONS)


def _events(address: str, prefix: str, since_ns: int = 0) -> list:
    """A filer's metadata events under `prefix` after `since_ns`, until
    its stream stays idle FT_IDLE_S."""
    import grpc

    from seaweedfs_tpu_torch.pb import filer_pb2

    out = []
    stub = rpc.filer_stub(rpc.grpc_address(address))
    stream = stub.SubscribeMetadata(filer_pb2.SubscribeMetadataRequest(
        client_name="chip_smoke", path_prefix=prefix, since_ns=since_ns))
    last = [time.perf_counter()]

    def watchdog():
        while stream.is_active():
            if time.perf_counter() - last[0] > FT_IDLE_S:
                stream.cancel()
                return
            time.sleep(0.2)

    threading.Thread(target=watchdog, daemon=True).start()
    try:
        for resp in stream:
            out.append(resp)
            last[0] = time.perf_counter()
    except grpc.RpcError as e:
        if e.code() != grpc.StatusCode.CANCELLED:
            raise
    return out


def _event_path(resp) -> str:
    """The path a filer's publisher keys an event by: the new entry's,
    else the old one's."""
    ev = resp.event_notification
    if ev.new_entry.name:
        return ((ev.new_parent_path or resp.directory).rstrip("/") + "/"
                + ev.new_entry.name)
    return resp.directory.rstrip("/") + "/" + ev.old_entry.name


def _tree_of(address: str, top: str) -> dict[str, int]:
    """{path: size} of every file under `top` (directories: -1), through
    the filer's gRPC listing."""
    out = {}
    for e in _filer_entries(address, top):
        p = f"{top.rstrip('/')}/{e.name}"
        if e.is_directory:
            out[p] = -1
            out.update(_tree_of(address, p))
        else:
            out[p] = max(e.attributes.file_size,
                         max((c.offset + c.size for c in e.chunks),
                             default=0), len(e.content))
    return out


def _local_files(root: str) -> dict[str, bytes]:
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            full = os.path.join(d, n)
            with open(full, "rb") as f:
                out["/" + os.path.relpath(full, root)] = f.read()
    return out


class _Tools:
    """The filer-tools step's processes and what they must hold: filer B,
    the fake Kafka broker B publishes to, filer.sync, filer.replicate,
    filer.meta.tail and filer.meta.backup, all over filer A."""

    def __init__(self, fleet: _Fleet, root: str, faddr: str, fenv: dict):
        self.fleet = fleet
        self.root = root
        self.faddr = faddr
        self.broker = _fake_kafka_broker()
        self.bdir = os.path.join(root, "filer-b")
        os.mkdir(self.bdir)
        with open(os.path.join(self.bdir, "notification.toml"), "w") as f:
            f.write(f'[notification.kafka]\nenabled = true\nhosts = '
                    f'["{self.broker.addr}"]\ntopic = "{FT_TOPIC}"\n')
        self.bport = _free_port_pair()
        while self.bport == fleet.master_port or self.bport in fleet.ports():
            self.bport = _free_port_pair()
        self.modules = {}
        # from its own directory, where its notification.toml is
        self.spawn("filerB", ["filer", "-ip", "127.0.0.1", "-port",
                              str(self.bport), "-master", fleet.master,
                              "-dir", os.path.join(self.bdir, "store"),
                              "-collection", FILER_COLLECTION],
                   self.bport, fenv, cwd=self.bdir)
        self.baddr = f"127.0.0.1:{self.bport}"
        self.replica = os.path.join(root, "replica")
        self.meta_backup = os.path.join(root, "meta.backup")

    def spawn(self, name: str, args: list, port: int = 0,
              env: dict | None = None, cwd: str = HERE) -> None:
        self.modules[name] = os.path.join(self.root, f"{name}.modules")
        self.fleet._spawn(name, args, port, "", env=env,
                          modules=self.modules[name], cwd=cwd)

    def start_tools(self) -> None:
        a, b = self.faddr, self.baddr
        self.spawn("filer.sync", ["filer.sync", "-a", a, "-b", b,
                                  "-a.path", "/sync", "-isActiveActive"])
        self.spawn("filer.replicate", ["filer.replicate", "-filer", a,
                                       "-path", "/sync", "-sink", "local",
                                       "-sink.dir", self.replica])
        self.spawn("filer.meta.tail", ["filer.meta.tail", "-filer", a,
                                       "-pathPrefix", "/sync"])
        self.spawn("filer.meta.backup", ["filer.meta.backup", "-filer", a,
                                         "-o", self.meta_backup])

    def stop(self, name: str) -> int:
        """SIGTERM: exit 0, neither jax nor seaweedfs_tpu in sys.modules;
        -> its exit code."""
        proc = self.fleet.procs[name][0]
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        with open(self.modules[name]) as f:
            mods = f.read().split("\n")
        jax_mods = [m for m in mods if m in ("jax", "seaweedfs_tpu")
                    or m.startswith(("jax.", "seaweedfs_tpu."))]
        if rc != 0 or jax_mods or "seaweedfs_tpu_torch.command" not in mods:
            raise AssertionError(f"{self.fleet.phase}: {name} exited {rc}; "
                                 f"jax or seaweedfs_tpu modules {jax_mods}")
        return rc

    def tail_events(self) -> list:
        """The events filer.meta.tail printed (its JSON lines)."""
        from google.protobuf.json_format import ParseDict

        from seaweedfs_tpu_torch.pb import filer_pb2

        with open(os.path.join(self.root, "filer.meta.tail.log"), "rb") as f:
            lines = f.read().decode(errors="replace").splitlines()
        return [ParseDict(json.loads(x), filer_pb2.SubscribeMetadataResponse())
                for x in lines if x.startswith("{")]

    def broker_messages(self) -> list[tuple[bytes, bytes]]:
        return [m for p in sorted(self.broker.messages)
                for m in list(self.broker.messages[p])]

    def close(self) -> None:
        self.broker.close()


def _tool(phase: str, fleet: _Fleet, *args: str, cwd: str = HERE
          ) -> tuple[bytes, float]:
    """One run of `python3 -m seaweedfs_tpu_torch <args>` to its end:
    exit 0 or the run fails; -> (stdout, seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch",
                        *args], cwd=cwd, env=fleet.env, capture_output=True,
                       timeout=CLUSTER_CALL_S)
    if r.returncode != 0:
        raise AssertionError(f"{phase}: {args[0]} exited {r.returncode}:\n"
                             f"{r.stderr.decode(errors='replace')[-4000:]}")
    return r.stdout, time.perf_counter() - t0


def _wait_until(phase: str, what: str, ok, timeout: float = FT_CONVERGE_S
                ) -> float:
    t0 = time.perf_counter()
    while not ok():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{phase}: {what} not within {timeout} s")
        time.sleep(0.2)
    return time.perf_counter() - t0


def _put_each(phase: str, port: int, items: dict, payload: bytes) -> float:
    """PUT {path: (start, size)} slices of `payload` by 8 clients;
    -> seconds."""
    def put(conn, path):
        a, n = items[path]
        conn.request("PUT", path, body=payload[a:a + n],
                     headers={"Content-Length": str(n)})
        r = conn.getresponse()
        r.read()
        if r.status != 201:
            raise AssertionError(f"{phase}: PUT {path}: {r.status}")

    t0 = time.perf_counter()
    _clients(port, put, sorted(items))
    return time.perf_counter() - t0


def _get_each_file(phase: str, port: int, want: dict) -> dict[str, float]:
    """GET every {path: bytes} by 8 readers, byte-exact; -> seconds of
    each."""
    def get(conn, path):
        t0 = time.perf_counter()
        st, body = _http(conn, "GET", path)
        dt = time.perf_counter() - t0
        if st != 200 or body != want[path]:
            raise AssertionError(f"{phase}: GET {path} on :{port}: {st}, "
                                 f"{len(body)} B, not the bytes written")
        return dt

    paths = sorted(want)
    return dict(zip(paths, _clients(port, get, paths)))


def _tools_writes(phase: str, fleet: _Fleet, tools: _Tools,
                  files: _FilerFiles, rng, smi: str) -> dict:
    """The filer-tools step before the encode (see the module
    docstring); -> what the reads after the loss need."""
    t_step = time.perf_counter()
    payload = files.payload
    aport = fleet.port_of(tools.faddr)
    fleet.wait_up(["filerB"])
    rpc.reset_channels()
    tools.start_tools()
    # until filer.replicate and filer.meta.tail follow A's stream: a
    # marker file seen by both, then deleted
    marker, n = "/sync/.ready", [0]

    def following() -> bool:
        n[0] += 1
        conn = http.client.HTTPConnection("127.0.0.1", aport, timeout=60)
        try:
            _http(conn, "PUT", marker, f"ready {n[0]}".encode())
        finally:
            conn.close()
        time.sleep(0.5)
        with open(os.path.join(tools.root, "filer.meta.tail.log"), "rb") as f:
            tailed = b'"name": ".ready"' in f.read()
        return tailed and os.path.exists(os.path.join(tools.replica,
                                                      ".ready"))

    up_s = _wait_until(phase, "filer.replicate and filer.meta.tail", following,
                       120)
    conn = http.client.HTTPConnection("127.0.0.1", aport, timeout=60)
    try:
        if _http(conn, "DELETE", marker)[0] not in (200, 202, 204):
            raise AssertionError(f"{phase}: DELETE {marker}")
    finally:
        conn.close()
    t_writes = time.time_ns()

    # 1. /sync on A by 8 clients; filer.meta.backup stopped once and
    # started again; /sync on B; a rename and a delete on A
    a_set = _gw_set(rng, len(payload), "/sync", FT_FILES, FT_LARGE_MIB,
                    FT_DIRS)
    a_s = _put_each(phase, aport, a_set, payload)
    tools.stop("filer.meta.backup")
    tools.spawn("filer.meta.backup2", ["filer.meta.backup", "-filer",
                                       tools.faddr, "-o", tools.meta_backup])
    b_set = {f"/sync/b/d{i % 2}/g{i:03d}": (
        int(rng.integers(0, len(payload) - 65536)),
        int(rng.integers(1, 65537))) for i in range(FT_B_FILES)}
    b_s = _put_each(phase, tools.bport, b_set, payload)
    want = {p: payload[a:a + n] for p, (a, n) in {**a_set, **b_set}.items()}
    src, dst = "/sync/d0/f0000", "/sync/d1/renamed"
    from seaweedfs_tpu_torch.pb import filer_pb2

    rpc.filer_stub(rpc.grpc_address(tools.faddr)).AtomicRenameEntry(
        filer_pb2.AtomicRenameEntryRequest(
            old_directory="/sync/d0", old_name="f0000",
            new_directory="/sync/d1", new_name="renamed"), timeout=120)
    want[dst] = want.pop(src)
    conn = http.client.HTTPConnection("127.0.0.1", aport, timeout=60)
    try:
        if _http(conn, "DELETE", "/sync/d2/f0002")[0] not in (200, 202, 204):
            raise AssertionError(f"{phase}: DELETE /sync/d2/f0002")
    finally:
        conn.close()
    del want["/sync/d2/f0002"]
    written = len(a_set) + len(b_set)

    # 2. both filers and the local sink converge on the same tree
    sizes = {p: len(b) for p, b in want.items()}

    def files_of(tree):
        return {p: z for p, z in tree.items() if z >= 0}

    t0 = time.perf_counter()
    converge_s = _wait_until(phase, "filer.sync's two trees", lambda: all(
        files_of(_tree_of(addr, "/sync")) == sizes
        for addr in (tools.faddr, tools.baddr)))
    replica_s = _wait_until(phase, "filer.replicate's local tree", lambda: {
        "/sync" + p: len(b) for p, b in _local_files(tools.replica).items()}
        == sizes)
    sync_s = time.perf_counter() - t0
    a_ms = _get_each_file(phase, aport, want)
    b_ms = _get_each_file(phase, tools.bport, want)
    mirrored = _local_files(tools.replica)
    if any(mirrored["/" + p[len("/sync/"):]] != b for p, b in want.items()):
        raise AssertionError(f"{phase}: the local sink's bytes differ")
    # no event looped: on each filer each path was created once
    loops = {}
    for name, addr in (("A", tools.faddr), ("B", tools.baddr)):
        made: dict[str, int] = {}
        for resp in _events(addr, "/sync", t_writes):
            if resp.event_notification.new_entry.name:
                p = _event_path(resp)
                made[p] = made.get(p, 0) + 1
        twice = {p: k for p, k in made.items() if k != 1 and p != marker}
        extra = set(made) - set(a_set) - set(b_set) - {dst, marker}
        if twice or extra:
            raise AssertionError(f"{phase}: events looped on {name}: "
                                 f"{twice}, unexpected {sorted(extra)[:5]}")
        loops[name] = len(made)
    log(phase, f"filer tools: filer B (-collection {FILER_COLLECTION}, "
               f"kafka at a FakeKafkaBroker) and filer.sync -isActiveActive, "
               f"filer.replicate -sink local, filer.meta.tail, "
               f"filer.meta.backup following A in {up_s:.2f} s; "
               f"{len(a_set)} files ({FT_FILES} of 1-64 KiB, one of "
               f"{FT_LARGE_MIB} MiB) PUT to A's /sync by {SERVER_CLIENTS} "
               f"clients in {a_s:.3f} s ({len(a_set) / a_s:.0f} files/s), "
               f"filer.meta.backup SIGTERMed (exit 0) and started again, "
               f"{len(b_set)} to B's /sync in {b_s:.3f} s, a rename across "
               f"directories and a delete on A: both filers converged "
               f"{converge_s:.2f} s after the last write "
               f"({written / (a_s + b_s + converge_s):.0f} files/s written "
               f"and synced), the local sink {replica_s:.2f} s later; every "
               f"file byte-exact on A ({_ms(list(a_ms.values()))}), on B "
               f"({_ms(list(b_ms.values()))}) and in the sink; each path "
               f"made once on each filer (A {loops['A']}, B {loops['B']}: "
               f"no event looped); nvidia-smi: {smi}")

    # 3. filer.copy of a local directory; filer.cat of the large file
    copy_dir = os.path.join(tools.root, "copy-src")
    copied = {}
    for i in range(FT_COPY_FILES):
        a, n = int(rng.integers(0, len(payload) - 65536)), int(
            rng.integers(1, 65537))
        rel = f"c{i % 5}/x{i:03d}"
        os.makedirs(os.path.join(copy_dir, f"c{i % 5}"), exist_ok=True)
        with open(os.path.join(copy_dir, rel), "wb") as f:
            f.write(payload[a:a + n])
        copied[f"/copied/{rel}"] = payload[a:a + n]
    out, copy_s = _tool(phase, fleet, "filer.copy", "-filer", tools.faddr,
                        copy_dir, "/copied")
    if out.decode().strip() != f"copied {FT_COPY_FILES} files to /copied":
        raise AssertionError(f"{phase}: filer.copy said {out!r}")
    _get_each_file(phase, aport, copied)
    out, cat_s = _tool(phase, fleet, "filer.cat", "-filer", tools.faddr,
                       "/sync/large.bin")
    if out != want["/sync/large.bin"]:
        raise AssertionError(f"{phase}: filer.cat gave {len(out)} B, not "
                             f"the bytes written")
    log(phase, f"filer.copy of {FT_COPY_FILES} local files in "
               f"{copy_s:.2f} s, each byte-exact through A; filer.cat of "
               f"/sync/large.bin ({FT_LARGE_MIB} MiB) byte-exact in "
               f"{cat_s:.2f} s; nvidia-smi: {smi}")

    # 4. remote storage: a local directory mounted, read through, cached,
    # partly uncached, changed, synced again
    rdir = os.path.join(tools.root, "remote-src")
    r_set = _gw_set(rng, len(payload), "", FT_REMOTE_FILES, FT_LARGE_MIB,
                    FT_DIRS)
    remote = {}
    for p, (a, n) in r_set.items():
        full = os.path.join(rdir, p.lstrip("/"))
        os.makedirs(os.path.dirname(full), exist_ok=True)
        with open(full, "wb") as f:
            f.write(payload[a:a + n])
        remote[p] = payload[a:a + n]
    _, conf_s = fleet.shell(f"remote.configure -name=r1 -type=local "
                            f"-root={rdir}", "remote.mount -dir=/remote "
                            f"-remote=r1", filer=tools.faddr)
    small = sorted(p for p in remote if p != "/large.bin")
    through = {f"/remote{p}": remote[p] for p in small[:FT_READ_THROUGH]}
    through_ms = _get_each_file(phase, aport, through)
    out, cache_s = fleet.shell(*[f"remote.cache -dir=/remote{p}"
                                 for p in sorted(remote)], filer=tools.faddr)
    if out.count("cached ") != len(remote):
        raise AssertionError(f"{phase}: remote.cache said:\n{out[-2000:]}")
    uncached = small[:FT_UNCACHE]
    changed = small[FT_UNCACHE:FT_UNCACHE + FT_CHANGED]
    _, uncache_s = fleet.shell(*[f"remote.uncache -dir=/remote{p}"
                                 for p in uncached], filer=tools.faddr)
    for i, p in enumerate(changed):
        a = int(rng.integers(0, len(payload) - 65536))
        remote[p] = payload[a:a + len(remote[p]) + 1 + i]
        full = os.path.join(rdir, p.lstrip("/"))
        with open(full, "wb") as f:
            f.write(remote[p])
        os.utime(full, (time.time() + 60, time.time() + 60))
    out, resync_s = _tool(phase, fleet, "filer.remote.sync", "-filer",
                          tools.faddr, "-dir", "/remote")
    if out.decode().strip() != f"synced {FT_CHANGED} entries":
        raise AssertionError(f"{phase}: filer.remote.sync said {out!r}")
    _get_each_file(phase, aport, {f"/remote{p}": remote[p] for p in changed})
    entries = {p: e for p, e in (
        (f"{d}/{e.name}", e) for d in {"/remote" + p.rsplit("/", 1)[0]
                                       for p in remote}
        for e in _filer_entries(tools.faddr, d.rstrip("/") or "/"))}
    cached = sorted(p for p in remote if entries[f"/remote{p}"].chunks)
    if set(cached) != set(remote) - set(uncached) - set(changed):
        raise AssertionError(f"{phase}: {len(cached)} remote files cached, "
                             f"not the {len(remote) - FT_UNCACHE - FT_CHANGED}"
                             f" kept")
    log(phase, f"remote storage (a local directory of {FT_REMOTE_FILES} "
               f"files of 1-64 KiB and one of {FT_LARGE_MIB} MiB): shell "
               f"-filer A remote.configure + remote.mount in {conf_s:.2f} "
               f"s; {FT_READ_THROUGH} files read through the filer "
               f"byte-exact ({_ms(list(through_ms.values()))}); "
               f"remote.cache of every file {cache_s:.2f} s; remote.uncache "
               f"of {FT_UNCACHE} {uncache_s:.2f} s; {FT_CHANGED} changed on "
               f"the remote, filer.remote.sync {resync_s:.2f} s (\"synced "
               f"{FT_CHANGED} entries\", the others' cache kept), their new "
               f"bytes read back; {len(cached)} files cached; nvidia-smi: "
               f"{smi}")

    # 5. fs.meta.notify from B's directory; the broker holds exactly B's
    # events and then one message per entry of B's /sync
    b_events = [r for r in _events(tools.baddr, "/")]
    before = tools.broker_messages()

    def key_value(key: bytes, value: bytes):
        ev = filer_pb2.EventNotification.FromString(value)
        return key, ev.SerializeToString(deterministic=True)

    expected = sorted((_event_path(r).encode(),
                       r.event_notification.SerializeToString(
                           deterministic=True)) for r in b_events)
    if sorted(key_value(k, v) for k, v in before) != expected:
        raise AssertionError(f"{phase}: the broker holds {len(before)} "
                             f"messages, not B's {len(expected)} events")
    b_tree = _tree_of(tools.baddr, "/sync")
    out, notify_s = fleet.shell("fs.meta.notify /sync", filer=tools.baddr,
                                cwd=tools.bdir)
    after = tools.broker_messages()
    notified = sorted(k.decode() for k, _ in (
        collections.Counter(after) - collections.Counter(before)).elements())
    if f"notified {len(b_tree)} entries under /sync" not in out or \
            len(after) - len(before) != len(b_tree) or \
            notified != sorted(b_tree) or tools.broker.crc_failures:
        raise AssertionError(f"{phase}: fs.meta.notify: {out!r}, "
                             f"{len(after) - len(before)} messages for "
                             f"{len(b_tree)} entries")
    log(phase, f"Kafka: the broker holds exactly B's {len(expected)} events "
               f"(expected {len(expected)}, received {len(before)}, by "
               f"(key, value) over {FT_PARTITIONS} partitions, CRCs "
               f"verified); fs.meta.notify /sync from shell -filer B in "
               f"B's directory ({notify_s:.2f} s): {len(b_tree)} messages "
               f"expected, {len(after) - len(before)} received; step "
               f"{time.perf_counter() - t_step:.2f} s; nvidia-smi: {smi}")
    return dict(want=want, remote=remote, rdir=rdir, cached=cached,
                dirs_a={f"/remote{p}".rsplit("/", 1)[0] for p in cached},
                dirs_b={p.rsplit("/", 1)[0] for p in want},
                written_s=time.perf_counter() - t_step)


def _tools_reads(phase: str, fleet: _Fleet, tools: _Tools, ftw: dict,
                 touching: set, smi: str) -> dict:
    """After the SIGKILL (4d): filer.backup of A's /sync and /remote, B's
    /sync through B by 8 readers, the cached /remote files through A;
    then every tool process and filer B SIGTERMed."""
    t_step = time.perf_counter()
    aport = fleet.port_of(tools.faddr)
    k0 = fleet.k1()
    backups = {}
    for top in ("/sync", "/remote"):
        target = os.path.join(tools.root, f"backup{top.replace('/', '-')}")
        out, dt = _tool(phase, fleet, "filer.backup", "-filer", tools.faddr,
                        "-path", top, "-target", target)
        got = _local_files(target)
        want = ({p[len("/sync"):]: b for p, b in ftw["want"].items()}
                if top == "/sync" else _local_files(ftw["rdir"]))
        if got != want:
            bad = sorted(p for p in set(got) | set(want)
                         if got.get(p) != want.get(p))
            raise AssertionError(f"{phase}: filer.backup -path {top}: "
                                 f"{len(bad)} files differ, e.g. {bad[:3]}")
        backups[top] = (len(got), dt)
    b_ms = _get_each_file(phase, tools.bport, ftw["want"])
    r_ms = _get_each_file(phase, aport, {f"/remote{p}": ftw["remote"][p]
                                         for p in ftw["cached"]})
    k1 = fleet.k1()
    reads_k1 = _k1_step(k0, k1)
    split = {}
    for name, ms, key in (("B's /sync", b_ms, lambda p: "B:" + p),
                          ("cached /remote", r_ms, lambda p: p)):
        split[name] = ([t for p, t in ms.items() if key(p) in touching],
                       [t for p, t in ms.items() if key(p) not in touching])
    # every tool, then filer B
    for name in ("filer.sync", "filer.replicate", "filer.meta.tail",
                 "filer.meta.backup2", "filerB"):
        tools.stop(name)
    # filer.meta.backup's records: each of A's events once, across its
    # restart
    from seaweedfs_tpu_torch.pb import filer_pb2

    with open(tools.meta_backup, "rb") as f:
        blob = f.read()
    ts, off = [], 0
    while off < len(blob):
        (n,) = struct.unpack_from(">I", blob, off)
        ts.append(filer_pb2.SubscribeMetadataResponse.FromString(
            blob[off + 4:off + 4 + n]).ts_ns)
        off += 4 + n
    a_ts = [r.ts_ns for r in _events(tools.faddr, "/")]
    if off != len(blob) or len(set(ts)) != len(ts) or set(ts) != set(a_ts):
        raise AssertionError(f"{phase}: filer.meta.backup holds {len(ts)} "
                             f"records ({len(ts) - len(set(ts))} repeated) "
                             f"of A's {len(a_ts)} events")
    tailed = tools.tail_events()
    first = tailed[0].ts_ns if tailed else 0
    on_a = [r.ts_ns for r in _events(tools.faddr, "/sync", first - 1)]
    if [r.ts_ns for r in tailed] != on_a:
        raise AssertionError(f"{phase}: filer.meta.tail printed "
                             f"{len(tailed)} events, A has {len(on_a)} "
                             f"under /sync since")
    log(phase, f"after the SIGKILL: filer.backup of A's /sync "
               f"({backups['/sync'][0]} files, {backups['/sync'][1]:.2f} s) "
               f"and /remote ({backups['/remote'][0]} files, uncached ones "
               f"read through the remote, {backups['/remote'][1]:.2f} s) "
               f"byte-exact; " + "; ".join(
                   f"{name} by {SERVER_CLIENTS} readers: {len(d)} with a "
                   f"chunk on a lost shard ({_ms(d)}), {len(r)} others "
                   f"({_ms(r)})" for name, (d, r) in split.items())
               + f"; K1 launches by R in these reads {reads_k1}; "
                 f"filer.meta.backup holds each of A's {len(a_ts)} events "
                 f"once across its restart, filer.meta.tail printed the "
                 f"{len(tailed)} under /sync; filer.sync, filer.replicate, "
                 f"filer.meta.tail, filer.meta.backup and filer B exit 0 "
                 f"on SIGTERM, none with jax or seaweedfs_tpu "
                 f"({time.perf_counter() - t_step:.2f} s); nvidia-smi: "
                 f"{smi}")
    if not reads_k1.get(4) or not all(d for d, _ in split.values()):
        raise AssertionError(f"{phase}: the tools' reads after the loss "
                             f"launched K1 by R {reads_k1}, or read no "
                             f"file with a chunk on a lost shard")
    return dict(split=split, k1=reads_k1)


# -- the postgres2 filer (the filer's network metadata stores) -----------------

PG_FILES = 200  # files of 1-64 KiB: PG_WIDE in one directory, the rest in
PG_WIDE = 150  # the buckets of PG_BUCKETS
PG_BUCKETS = ("pg-one", "pg-two")  # one table each in the fake
PG_LARGE_MIB = 24
PG_SAMPLE = 100  # files listed and read back after its restart
PG_USER = ("weed", "pg-secret-0001")


def _modules_clean(phase: str, path: str, loaded: str) -> None:
    """The module list a process wrote as it exited holds `loaded` and
    neither jax nor anything of seaweedfs_tpu."""
    with open(path) as f:
        mods = f.read().split("\n")
    bad = [m for m in mods if m in ("jax", "seaweedfs_tpu")
           or m.startswith(("jax.", "seaweedfs_tpu."))]
    if bad or loaded not in mods:
        raise AssertionError(f"{phase}: modules {bad[:5]}, {loaded} "
                             f"loaded: {loaded in mods}")


class _StoreFiles(_FilerFiles):
    """The postgres2 filer's set: slices of the filer step's payload."""

    def __init__(self, payload: bytes, rng):
        self.payload = payload
        self.items = {}
        for i in range(PG_FILES):
            size = int(rng.integers(1, 64 * 1024 + 1))
            start = int(rng.integers(0, len(payload) - size))
            if i < PG_WIDE:
                path = f"/pg/wide/w{i:04d}"
            else:
                b = PG_BUCKETS[i % len(PG_BUCKETS)]
                path = f"/buckets/{b}/d{i % 3}/o{i:04d}"
            self.items[path] = (start, size)
        size = PG_LARGE_MIB * MIB
        self.items["/pg/big/large.bin"] = (
            int(rng.integers(0, len(payload) - size)), size)


class _PgFiler:
    """A filer on the postgres2 store: the fake server in this process,
    and the filer's processes, each started from a directory whose
    filer.toml enables [postgres2] at the fake."""

    def __init__(self, fleet: _Fleet, root: str, fenv: dict):
        self.fleet = fleet
        self.root = root
        self.fenv = fenv
        self.server = _test_module("fake_postgres").FakePostgresServer(
            auth="scram", user=PG_USER[0], password=PG_USER[1])
        self.dir = os.path.join(root, "filer-pg")
        os.mkdir(self.dir)
        with open(os.path.join(self.dir, "filer.toml"), "w") as f:
            f.write(f'[postgres2]\nenabled = true\nhost = "127.0.0.1"\n'
                    f'port = {self.server.port}\nuser = "{PG_USER[0]}"\n'
                    f'password = "{PG_USER[1]}"\n'
                    f'database = "seaweedfs"\n')
        self.modules = {}
        self.port = self.spawn("filerPG")

    def spawn(self, name: str) -> int:
        port = _free_port_pair()
        while port == self.fleet.master_port or port in self.fleet.ports():
            port = _free_port_pair()
        self.modules[name] = os.path.join(self.root, f"{name}.modules")
        # -dir only for the chunk cache (off): the store is the fake's
        self.fleet._spawn(name, ["filer", "-ip", "127.0.0.1", "-port",
                                 str(port), "-master", self.fleet.master,
                                 "-dir", os.path.join(self.dir, "store"),
                                 "-collection", FILER_COLLECTION],
                          port, "", env=self.fenv,
                          modules=self.modules[name], cwd=self.dir)
        self.port = port
        return port

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def tables(self) -> dict[str, int]:
        """{table: rows} in the fake."""
        with self.server._dblock:
            names = [r[0] for r in self.server.db.execute(
                "SELECT name FROM sqlite_master WHERE type='table'")]
            return {n: self.server.db.execute(
                f'SELECT count(*) FROM "{n}"').fetchone()[0] for n in names}

    def stop(self, name: str) -> float:
        """SIGTERM: exit 0, the postgres client loaded, neither jax nor
        seaweedfs_tpu in sys.modules; -> seconds to exit."""
        proc = self.fleet.procs[name][0]
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        dt = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"{self.fleet.phase}: {name} exited {rc}")
        _modules_clean(self.fleet.phase, self.modules[name],
                       "seaweedfs_tpu_torch.filer.stores.pg_wire")
        return dt

    def close(self) -> None:
        self.server.stop()


def _stores_writes(phase: str, pgf: _PgFiler, payload: bytes, rng) -> dict:
    """The stores step before the encode: every file PUT through the
    postgres2 filer by 8 clients; -> what the reads after the loss
    need."""
    files = _StoreFiles(payload, rng)
    paths = sorted(files.items, key=lambda p: (files.items[p][1]
                                               > 64 * 1024, p))
    md5, write_s = _filer_put_all(phase, pgf.port, files, paths)
    large = _filer_entries(pgf.address, "/pg/big")
    tables = pgf.tables()
    buckets = {b: tables.get(f"bucket_{b}", 0) for b in PG_BUCKETS}
    want = {b: sum(p.startswith(f"/buckets/{b}/") for p in paths)
            for b in PG_BUCKETS}
    # a bucket's table holds its files and their directories
    if not all(buckets[b] >= want[b] for b in PG_BUCKETS) or \
            len(large) != 1 or len(large[0].chunks) != 6:
        raise AssertionError(f"{phase}: postgres2 holds {tables}; the "
                             f"24 MiB file in "
                             f"{[len(e.chunks) for e in large]} chunks")
    total = sum(n for _, n in files.items.values())
    log(phase, f"postgres2 filer (`filer` from a directory whose filer.toml "
               f"enables [postgres2] at a FakePostgresServer, SCRAM): "
               f"{len(paths)} files ({total} B: {PG_FILES} of 1-64 KiB, "
               f"{PG_WIDE} in /pg/wide, the rest in buckets "
               f"{'/'.join(PG_BUCKETS)}; one of {PG_LARGE_MIB} MiB in 6 "
               f"chunks) PUT by {SERVER_CLIENTS} clients in {write_s:.3f} s "
               f"= {len(paths) / write_s:.0f} files/s; the fake's tables "
               f"{tables}")
    return dict(files=files, paths=paths, md5=md5, write_s=write_s)


def _stores_reads(phase: str, fleet: _Fleet, pgf: _PgFiler, sw: dict,
                  touching: set, seed: int) -> dict:
    """The stores step after the SIGKILL (see the module docstring);
    -> its numbers for the phase's last line."""
    files, paths, md5 = sw["files"], sw["paths"], sw["md5"]
    t_step = time.perf_counter()
    k0 = fleet.k1()
    got_ms = _filer_get_all(phase, pgf.port, files, paths, md5)
    k1 = _k1_step(k0, fleet.k1())
    deg = [t for p, t in zip(paths, got_ms) if f"PG:{p}" in touching]
    rest = [t for p, t in zip(paths, got_ms) if f"PG:{p}" not in touching]
    if not deg or not k1.get(4):
        raise AssertionError(f"{phase}: the postgres2 filer's GETs: "
                             f"{len(deg)} on a lost shard, K1 by R {k1}")
    conn = http.client.HTTPConnection("127.0.0.1", pgf.port, timeout=120)
    try:
        t0 = time.perf_counter()
        names, last, pages = [], "", 0
        while True:
            st, body = _http(conn, "GET", f"/pg/wide/?limit={FILER_PAGE}"
                                          f"&lastFileName={last}")
            page = json.loads(body)
            pages += 1
            names += [e["FullPath"] for e in page["Entries"]]
            if st != 200 or not page["ShouldDisplayLoadMore"]:
                break
            last = page["Entries"][-1]["FullPath"].rsplit("/", 1)[1]
        list_s = time.perf_counter() - t0
        wide = sorted(p for p in paths if p.startswith("/pg/wide/"))
        if names != wide:
            raise AssertionError(f"{phase}: the postgres2 filer lists "
                                 f"{len(names)} names in /pg/wide")
        gone_bucket = PG_BUCKETS[1]
        st, _ = _http(conn, "DELETE", f"/buckets/{gone_bucket}"
                                      f"?recursive=true")
        gone = [p for p in paths if p.startswith(f"/buckets/{gone_bucket}/")]
        st2, _ = _http(conn, "GET", gone[0])
        tables = pgf.tables()
        if st != 204 or st2 != 404 or f"bucket_{gone_bucket}" in tables:
            raise AssertionError(f"{phase}: DELETE of bucket {gone_bucket}: "
                                 f"{st}, then GET {st2}; tables {tables}")
    finally:
        conn.close()
    paths = [p for p in paths if p not in gone]
    term_s = pgf.stop("filerPG")
    t0 = time.perf_counter()
    pgf.spawn("filerPG2")
    fleet.wait_up(["filerPG2"])
    restart_s = time.perf_counter() - t0
    rpc.reset_channels()
    sample = sorted(np.random.default_rng(seed + 2).choice(
        paths, size=PG_SAMPLE, replace=False).tolist())
    for d in sorted({p.rsplit("/", 1)[0] for p in sample}):
        got = sorted(f"{d}/{e.name}" for e in _filer_entries(pgf.address, d)
                     if not e.is_directory)
        if got != sorted(p for p in paths if p.rsplit("/", 1)[0] == d):
            raise AssertionError(f"{phase}: after its restart the postgres2 "
                                 f"filer lists {len(got)} entries in {d}")
    again = _filer_get_all(phase, pgf.port, files, sample, md5)
    pgf.stop("filerPG2")
    log(phase, f"postgres2 filer after the SIGKILL: every file GET "
               f"byte-exact with its md5 ETag by {SERVER_CLIENTS} readers: "
               f"{len(deg)} with a chunk on a lost shard ({_ms(deg)}), "
               f"{len(rest)} others ({_ms(rest)}); K1 launches by R {k1}; "
               f"/pg/wide listed in {pages} pages of {FILER_PAGE} in "
               f"{list_s:.3f} s; DELETE /buckets/{gone_bucket} 204 and its "
               f"table dropped ({len(gone)} files); SIGTERM: exit 0 in "
               f"{term_s:.2f} s, a new filer on the same server up in "
               f"{restart_s:.2f} s: a sample of {len(sample)} files listed "
               f"and read back ({_ms(again)}); neither process had jax or "
               f"seaweedfs_tpu in sys.modules; the step "
               f"{time.perf_counter() - t_step:.2f} s after the loss")
    return dict(deg=deg, rest=rest, k1=k1, list_s=list_s,
                restart_s=restart_s,
                files_s=len(sw["paths"]) / sw["write_s"])


TIER_VID = 900  # the tiered volume, allocated on its own server
TIER_COLLECTION = "tier"
TIER_BUCKET = "tier"  # the S3 bucket the tier backend writes into
TIER_MB = 32  # needle bytes of 1-64 KiB in the tiered volume
# readers of the tiered volume: each read crosses the volume server, the
# gateway, the filer and the erasure-coded chunk's servers, so it waits
# far more than it works
TIER_READERS = 32


def _tier_config(root: str, sport: int) -> str:
    """The -tierConfig file: an `s3` backend at the fleet's own gateway,
    signed with the S3 step's identity; -> its path."""
    path = os.path.join(root, "tier.json")
    with open(path, "w") as f:
        json.dump({"s3": {"default": {
            "endpoint": f"http://127.0.0.1:{sport}", "bucket": TIER_BUCKET,
            "access_key": S3_IDENTITY[1], "secret_key": S3_IDENTITY[2]}}}, f)
    return path


def _tier_writes(phase: str, fleet: _Fleet, vt: str, sport: int,
                 payload: bytes, rng) -> dict:
    """Before the encode: TIER_MB of seeded needles into the volume on `vt`,
    `volume.tier.upload` of it to the S3 gateway's bucket, every needle
    read back from the remote .dat; -> what the reads after the loss
    need."""
    s3 = _S3Client(sport)
    conn = http.client.HTTPConnection("127.0.0.1", sport, timeout=600)
    try:
        st, body, _ = s3.call(conn, "PUT", f"/{TIER_BUCKET}")
        if st != 200:
            raise AssertionError(f"{phase}: bucket {TIER_BUCKET}: {st} {body}")
    finally:
        conn.close()
    needles, total = [], 0
    while total < TIER_MB * MIB:
        size = int(rng.integers(1, 64 * 1024 + 1))
        needles.append((len(needles) + 1, int(rng.integers(1, 1 << 32)),
                        int(rng.integers(0, len(payload) - size)), size))
        total += size
    port = fleet.port_of(vt)

    def put(conn, needle):
        nid, cookie, start, size = needle
        status, _ = _http(conn, "POST", "/" + _fid(nid, cookie, TIER_VID),
                          payload[start:start + size])
        if status != 201:
            raise AssertionError(f"{phase}: POST of tier needle {nid}: "
                                 f"{status}")

    t0 = time.perf_counter()
    _clients(port, put, needles)
    write_s = time.perf_counter() - t0
    base = os.path.join(fleet.volumes()[vt][1],
                        f"{TIER_COLLECTION}_{TIER_VID}")
    dat_sha, dat_bytes = _sha_file(base + ".dat"), os.path.getsize(
        base + ".dat")
    out, up_s = fleet.shell(
        "lock", f"volume.tier.upload -node {vt} -volumeId {TIER_VID} "
                f"-dest s3", "unlock")
    if f"moved {dat_bytes} bytes" not in out or \
            os.path.exists(base + ".dat") or not os.path.exists(
                base + ".tier"):
        raise AssertionError(f"{phase}: volume.tier.upload said:\n{out}")
    conn = http.client.HTTPConnection("127.0.0.1", sport, timeout=600)
    try:
        st, _, r = s3.call(conn, "HEAD",
                           f"/{TIER_BUCKET}/{TIER_COLLECTION}_{TIER_VID}.dat")
        if st != 200 or int(r.getheader("Content-Length")) != dat_bytes:
            raise AssertionError(f"{phase}: the tiered object: {st}")
    finally:
        conn.close()
    r0 = dict(REDIRECTS)
    read_ms = _get_all(phase, port, needles, payload, vid=TIER_VID,
                       clients=TIER_READERS)
    hops = REDIRECTS["GET"] - r0.get("GET", 0)
    log(phase, f"tiering: volume {TIER_VID} (collection {TIER_COLLECTION}) "
               f"on {vt} (-tierConfig: an s3 backend at this fleet's S3 "
               f"gateway, bucket {TIER_BUCKET}): {len(needles)} needles "
               f"({total} B of 1-64 KiB; a deployment's volume holds up to "
               f"30 GB) POSTed by {SERVER_CLIENTS} clients in "
               f"{write_s:.3f} s; shell volume.tier.upload moved its .dat "
               f"({dat_bytes} B, sha256 {dat_sha[:16]}...) in {up_s:.3f} s = "
               f"{dat_bytes / up_s / 1e6:.1f} MB/s of shell wall; the .dat "
               f"left the disk, the bucket holds it; every needle read back "
               f"byte-exact from the remote .dat ({_ms(read_ms)}, "
               f"{total / sum(read_ms) * TIER_READERS / 1e6:.1f} MB/s by "
               f"{TIER_READERS} readers; {hops} through the C++ plane's "
               f"307, which let go of the volume)")
    if hops != len(needles):
        raise AssertionError(f"{phase}: {hops} of {len(needles)} tiered "
                             f"GETs were handed to Python")
    return dict(vt=vt, needles=needles, base=base, sha=dat_sha,
                bytes=dat_bytes, total=total)


def _tier_reads(phase: str, fleet: _Fleet, tw: dict, payload: bytes) -> dict:
    """After the loss: every tiered needle read again (the bucket's chunks
    are erasure-coded, K1 at R = 4), `volume.tier.download`, the .dat
    back with its sha256, every needle read once more."""
    vt, port = tw["vt"], fleet.port_of(tw["vt"])
    k0 = fleet.k1()
    t0 = time.perf_counter()
    lost_ms = _get_all(phase, port, tw["needles"], payload, vid=TIER_VID,
                       clients=TIER_READERS)
    lost_s = time.perf_counter() - t0
    k1 = _k1_step(k0, fleet.k1())
    if not k1.get(4):
        raise AssertionError(f"{phase}: the tiered reads after the loss "
                             f"launched K1 by R {k1}, none at R = 4")
    out, down_s = fleet.shell(
        "lock", f"volume.tier.download -node {vt} -volumeId {TIER_VID}",
        "unlock")
    if f"downloaded {tw['bytes']} bytes" not in out or \
            os.path.exists(tw["base"] + ".tier") or \
            _sha_file(tw["base"] + ".dat") != tw["sha"]:
        raise AssertionError(f"{phase}: volume.tier.download said:\n{out}")
    local_ms = _get_all(phase, port, tw["needles"], payload, vid=TIER_VID)
    log(phase, f"tiering after the loss: every tiered needle read back "
               f"byte-exact through the gateway and the erasure-coded "
               f"bucket by {TIER_READERS} readers in {lost_s:.3f} s "
               f"({tw['total'] / lost_s / 1e6:.1f} MB/s; {_ms(lost_ms)}; K1 "
               f"launches by R {k1}); shell "
               f"volume.tier.download in {down_s:.3f} s = "
               f"{tw['bytes'] / down_s / 1e6:.1f} MB/s of shell wall, the "
               f".dat back with its sha256; every needle read once more "
               f"({_ms(local_ms)})")
    return dict(k1=k1, lost_ms=lost_ms, down_s=down_s)


def filer_phase(seed: int, workdir: str, card: str, smi: str) -> dict:
    """The filer as an operator runs it (see the module docstring):
    files written through its HTTP API, their volumes erasure-coded by
    the shell's streamed `ec.encode` (K1 at R = 4 on each source), every
    file read back through it with a 4-shard server lost (K1 at R = 4 on
    the survivors), `shell -filer`, a restart on its sqlite store; in its
    fleet the S3, gateway, filer-tools and postgres2 filer steps;
    -> K1's launches."""
    from seaweedfs_tpu_torch.pb import filer_pb2
    from seaweedfs_tpu_torch.storage.file_id import parse_file_id

    phase = "filer"
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix=f"{phase}-", dir=workdir)
    fleet = _Fleet(phase, root)
    gw = tools = pgf = None
    fdir = os.path.join(root, "filer-store")
    # the filer's chunk cache off: every GET below reaches the volume
    # servers, so that the degraded ones are K1's reconstructions
    fenv = {"SWFS_FILER_CACHE_MB": "0"}
    try:
        fleet._spawn("master", ["master", "-ip", "127.0.0.1", "-port",
                                str(fleet.master_port), "-volumeSizeLimitMB",
                                str(FILER_LIMIT_MB)], fleet.master_port, "")
        for i, rack in enumerate(CLUSTER_RACKS):
            fleet.spawn_volume(f"v{i}", rack)
        fport = fleet.spawn_filer("filer", FILER_COLLECTION, fdir, fenv)
        faddr = f"127.0.0.1:{fport}"
        sport = _free_port_pair()
        while sport in fleet.ports() + [fleet.master_port]:
            sport = _free_port_pair()
        # the tiered volume's server: room for it and one more volume
        fleet.spawn_volume("vt", "r0", args=(
            "-max", "2", "-tierConfig", _tier_config(root, sport)))
        s3_modules = os.path.join(root, "s3.modules")
        fleet._spawn("s3", ["s3", "-port", str(sport), "-filer", faddr],
                     sport, "", modules=s3_modules)
        gw = _Gateways(fleet, root, faddr)
        tools = _Tools(fleet, root, faddr, fenv)
        pgf = _PgFiler(fleet, root, fenv)
        up_s = fleet.wait_up(["master", "filer", "s3", "filerPG", "vt"] +
                             [f"v{i}" for i in range(len(CLUSTER_RACKS))])
        gw.wait_up(["webdav", "ftp", "iam", "mq"]
                   + (["mount"] if gw.kernel else []))
        up_s = time.perf_counter() - t_phase
        rpc.reset_channels()  # no channel dialled before the listeners
        # the tiered volume, before the filer's writes grow volumes there
        vt = next(a for a, (n, _) in fleet.volumes().items() if n == "vt")
        rpc.volume_stub(rpc.grpc_address(vt)).AllocateVolume(
            vs.AllocateVolumeRequest(volume_id=TIER_VID,
                                     collection=TIER_COLLECTION,
                                     replication="000"), timeout=60)
        log(phase, f"one master (-volumeSizeLimitMB {FILER_LIMIT_MB}), "
                   f"{len(CLUSTER_RACKS)} volume servers (default coder, "
                   f"racks {'/'.join(CLUSTER_RACKS)}), a filer (-store "
                   f"sqlite, -maxMB 4, -collection {FILER_COLLECTION}, "
                   f"chunk cache off), a second filer on postgres2, an S3 "
                   f"gateway, WebDAV, FTP, IAM and MQ gateways and "
                   f"{'a kernel mount' if gw.kernel else 'an in-process mount'}"
                   f" over it started at once: up in {up_s:.2f} s")

        # 2. about 0.6 GB of files through the filer's HTTP API, 8 clients
        rng = np.random.default_rng(seed)
        files = _FilerFiles(rng)
        paths = sorted(files.items, key=lambda p: (files.items[p][1]
                                                   > 64 * 1024, p))
        md5, write_s = _filer_put_all(phase, fport, files, paths)
        total = sum(len(files.data(p)) for p in paths)
        large = [p for p in paths if p.startswith("/fs/big/")]
        nchunks = {len(e.chunks) for e in _filer_entries(faddr, "/fs/big")}
        if min(nchunks) < 2 or max(nchunks) > 16:
            raise AssertionError(f"{phase}: large files in {nchunks} chunks")
        live_ms = _filer_get_all(phase, fport, files, paths, md5)
        conn = http.client.HTTPConnection("127.0.0.1", fport, timeout=120)
        try:
            for p in large[:4]:
                a, b = FILER_CHUNK - 1000, FILER_CHUNK + 999
                conn.request("GET", p, headers={"Range": f"bytes={a}-{b}"})
                r = conn.getresponse()
                body = r.read()
                if r.status != 206 or body != files.data(p)[a:b + 1] or \
                        r.getheader("Content-Range") != \
                        f"bytes {a}-{b}/{len(files.data(p))}":
                    raise AssertionError(f"{phase}: range GET of {p}: "
                                         f"{r.status}")
            names, last, pages = [], "", 0
            while True:
                conn.request("GET", f"/fs/wide/?limit={FILER_PAGE}"
                                    f"&lastFileName={last}")
                r = conn.getresponse()
                page = json.loads(r.read())
                pages += 1
                names += [e["FullPath"] for e in page["Entries"]]
                if not page["ShouldDisplayLoadMore"]:
                    break
                last = page["Entries"][-1]["FullPath"].rsplit("/", 1)[1]
            wide = sorted(p for p in paths if p.startswith("/fs/wide/"))
            if names != wide:
                raise AssertionError(f"{phase}: the paged listing of "
                                     f"/fs/wide gave {len(names)} names")
            # the filer's HTML listing (server/ui.py)
            status, page = _http(conn, "GET", "/fs/wide/?ui=1")
            if status != 200 or not all(
                    f">{p.rsplit('/', 1)[1]}<".encode() in page
                    for p in wide):
                raise AssertionError(f"{phase}: the /fs/wide/?ui page: "
                                     f"{status}, {len(page)} B")
            # one rename through the filer's gRPC API, one recursive delete
            moved = large[0].replace("/L", "/moved-L")
            rpc.filer_stub(rpc.grpc_address(faddr)).AtomicRenameEntry(
                filer_pb2.AtomicRenameEntryRequest(
                    old_directory="/fs/big", old_name=large[0][8:],
                    new_directory="/fs/big", new_name=moved[8:]),
                timeout=120)
            files.items[moved] = files.items.pop(large[0])
            md5[moved] = md5.pop(large[0])
            gone = [p for p in paths if p.startswith("/fs/d7/")]
            conn.request("DELETE", "/fs/d7?recursive=true")
            r = conn.getresponse()
            r.read()
            if r.status != 204:
                raise AssertionError(f"{phase}: recursive DELETE: {r.status}")
            for p in (large[0], gone[0]):
                conn.request("GET", p)
                r = conn.getresponse()
                r.read()
                if r.status != 404:
                    raise AssertionError(f"{phase}: GET {p}: {r.status}")
        finally:
            conn.close()
        for p in gone:
            del files.items[p]
        paths = sorted(files.items)
        _filer_get_all(phase, fport, files, [moved], md5)
        log(phase, f"{len(paths) + len(gone)} files ({total} B: "
                   f"{FILER_SMALL + 1} of 1-64 KiB, {FILER_WIDE} of them in "
                   f"one directory, the rest in {FILER_DIRS} nested ones; "
                   f"{FILER_LARGE} of 8-64 MiB in {min(nchunks)}-"
                   f"{max(nchunks)} chunks) PUT through the filer by "
                   f"{SERVER_CLIENTS} clients in {write_s:.3f} s = "
                   f"{total / write_s / 1e9:.3f} GB/s, "
                   f"{(len(paths) + len(gone)) / write_s:.0f} files/s; "
                   f"every file GET byte-exact with its md5 ETag "
                   f"({_ms(live_ms)}); range GETs across a chunk boundary; "
                   f"/fs/wide listed in {pages} pages of {FILER_PAGE} and "
                   f"as its HTML page ({len(page)} B, every file named); "
                   f"{large[0]} renamed (gRPC AtomicRenameEntry); /fs/d7 "
                   f"deleted recursively ({len(gone)} files)")

        # 2b. the S3 gateway: credentials, objects, listings, copies, and
        # the CLI's benchmark
        s3w = _s3_writes(phase, fleet, sport, faddr, files, rng)

        # 2c. the other gateways: mount, WebDAV, FTP, IAM, MQ
        gwr = _gateway_writes(phase, gw, files, rng, sport, s3w)

        # 2d. the filer's tools: filer B, filer.sync, filer.replicate, the
        # metadata tail and backup, filer.copy and filer.cat, remote
        # storage, Kafka
        ftw = _tools_writes(phase, fleet, tools, files, rng, smi)

        # 2e. a filer on a network metadata store: postgres2
        sw = _stores_writes(phase, pgf, files.payload, rng)

        # 2f. a volume tiered to the S3 gateway: its bucket's chunks are
        # erasure-coded below with the rest
        tw = _tier_writes(phase, fleet, vt, sport, files.payload, rng)

        # 3. the shell's streamed ec.encode of every volume holding chunks
        vols = _filer_volumes(fleet)
        _wait_listed(fleet, vols)
        keep = {}
        for vid, (addr, d) in vols.items():
            keep[vid] = os.path.join(root, f"keep-{vid}")
            for ext in (".dat", ".idx"):
                os.link(os.path.join(d, f"{FILER_COLLECTION}_{vid}{ext}"),
                        keep[vid] + ext)
        sources = sorted({a for a, _ in vols.values()})
        src_k0 = {a: _kernel_launches(fleet.port_of(a)) for a in sources}
        k0 = fleet.k1()
        out, enc_s = fleet.shell(
            "lock", f"ec.encode -collection {FILER_COLLECTION} "
                    f"-fullPercent 0.001", "unlock")
        said = _streamed(phase, out)
        if sorted(said) != sorted(vols):
            raise AssertionError(f"{phase}: ec.encode streamed {sorted(said)}"
                                 f", the volumes holding chunks are "
                                 f"{sorted(vols)}")
        for vid in vols:
            _wait_ec(fleet, vid, 14, plain=False)
        k1 = fleet.k1()
        src_k1 = {a: {int(r): n - src_k0[a].get((k, r), 0)
                      for (k, r), n in _kernel_launches(
                          fleet.port_of(a)).items()
                      if k == "gf_xor" and r and n - src_k0[a].get((k, r), 0)}
                  for a in sources}
        geo = Geometry()
        t0 = time.perf_counter()
        oracles = dict(zip(vols, _all_at_once(
            lambda vid: cpu_oracle_hashes(keep[vid], geo, workdir), vols)))
        oracle_s = time.perf_counter() - t0
        where = {vid: _check_ec(phase, fleet, f"{FILER_COLLECTION}_{vid}",
                                geo, oracles[vid]) for vid in vols}
        dat_bytes = sum(os.path.getsize(k + ".dat") for k in keep.values())
        enc_k1 = _k1_step(k0, k1)
        log(phase, f"shell lock; ec.encode -collection {FILER_COLLECTION} "
                   f"-fullPercent 0.001; unlock (streamed): {enc_s:.3f} s of "
                   f"shell wall for {len(vols)} volumes ({dat_bytes} B of "
                   f".dat, {dat_bytes / enc_s / 1e9:.3f} GB/s) from "
                   f"{len(sources)} sources; 14 shard sha256s of each "
                   f"match the numpy cpu coder ({oracle_s:.1f} s); K1 "
                   f"launches by R on each source {src_k1}, on every "
                   f"server {enc_k1}")
        if not all(src_k1[a].get(4) for a in sources):
            raise AssertionError(f"{phase}: ec.encode did not launch K1 at "
                                 f"R = 4 on every source: {src_k1}")

        # 4. a server holding 4 shards lost; every file GET by 8 readers
        held: dict[str, dict[int, list[int]]] = {}
        for vid, w in where.items():
            for sid, a in w.items():
                held.setdefault(a, {}).setdefault(vid, []).append(sid)
        held.pop(vt, None)  # the tiered volume's server stays up
        victim = max(sorted(held), key=lambda a: (
            max(len(s) for s in held[a].values()) == 4,
            sum(len(s) for s in held[a].values())))
        lost = held[victim]
        if max(len(s) for s in lost.values()) != 4:
            raise AssertionError(f"{phase}: no server holds 4 shards: "
                                 f"{held}")
        chunks_of = {}
        s3_dirs = {f"/buckets/{S3_BUCKET}/{k.rsplit('/', 1)[0]}"
                   for k in s3w["data"]}
        gw_dirs = {p.rsplit("/", 1)[0] for g in ("mount", "dav", "ftp")
                   for p in gwr[g]["items"]}
        for d in sorted({p.rsplit("/", 1)[0] for p in paths} | s3_dirs
                        | gw_dirs | ftw["dirs_a"]):
            for e in _filer_entries(faddr, d):
                chunks_of[f"{d}/{e.name}"] = [parse_file_id(c.file_id)
                                              for c in e.chunks]
        for d in sorted(ftw["dirs_b"]):  # filer B's, keyed "B:<path>"
            for e in _filer_entries(tools.baddr, d):
                chunks_of[f"B:{d}/{e.name}"] = [parse_file_id(c.file_id)
                                                for c in e.chunks]
        for d in sorted({p.rsplit("/", 1)[0] for p in sw["paths"]}):
            for e in _filer_entries(pgf.address, d):  # keyed "PG:<path>"
                chunks_of[f"PG:{d}/{e.name}"] = [parse_file_id(c.file_id)
                                                 for c in e.chunks]
        where_of = {}
        for vid, k in keep.items():
            ids, offs, sizes = idx.read_index_file(k + ".idx")
            where_of[vid] = {int(n): (types.stored_to_actual_offset(int(o)),
                                      types.actual_size(int(z)))
                             for n, o, z in zip(ids, offs, sizes)}
        touching = set()
        for vid in vols:
            extents = [(p, *where_of[vid][f.key]) for p, fs in
                       chunks_of.items() for f in fs if f.volume_id == vid]
            hit, _ = split_by_lost(geo, os.path.getsize(keep[vid] + ".dat"),
                                   extents, lost.get(vid, []))
            touching |= set(hit)
        fleet.kill(victim)
        k2 = fleet.k1()
        got_ms = _filer_get_all(phase, fport, files, paths, md5)
        k3 = fleet.k1()
        deg = [t for p, t in zip(paths, got_ms) if p in touching]
        rest = [t for p, t in zip(paths, got_ms) if p not in touching]
        get_k1 = _k1_step(k2, k3)
        log(phase, f"SIGKILL of {victim} (shards by volume {lost}); every "
                   f"surviving file GET byte-exact through the filer by "
                   f"{SERVER_CLIENTS} readers: {len(deg)} with a chunk on a "
                   f"lost shard ({_ms(deg)}), {len(rest)} others "
                   f"({_ms(rest)}); K1 launches by R {get_k1}")
        if not get_k1.get(4):
            raise AssertionError(f"{phase}: the degraded GETs launched K1 "
                                 f"by R {get_k1}, none at R = 4")

        # 4t. the tiered volume read through the erasure-coded bucket,
        # then downloaded
        tr = _tier_reads(phase, fleet, tw, files.payload)

        # 4a. the postgres2 filer's files, listing, bucket delete, restart
        pgr = _stores_reads(phase, fleet, pgf, sw, touching, seed)

        # 4b. every S3 object read back through the gateway; its SIGTERM
        s3r = _s3_reads(phase, fleet, sport, faddr, s3w, touching)
        proc = fleet.procs["s3"][0]
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        with open(s3_modules) as f:
            mods = f.read().split("\n")
        jax_mods = [m for m in mods if m in ("jax", "seaweedfs_tpu")
                    or m.startswith(("jax.", "seaweedfs_tpu."))]
        if rc != 0 or "seaweedfs_tpu_torch.s3api.server" not in mods or \
                jax_mods:
            raise AssertionError(f"{phase}: the s3 process exited {rc}; "
                                 f"jax or seaweedfs_tpu modules {jax_mods}")
        log(phase, f"s3 SIGTERM: exit 0, {len(mods)} modules and none of "
                   f"jax or seaweedfs_tpu in its sys.modules")

        # 4c. every file of the other gateways read back through them
        gwo = _gateway_reads(phase, gw, files, gwr, touching)
        # the broker flushes to its filer as it stops: before the filer
        # restarts on another port
        dt = gw.stop("mq2")
        log(phase, f"the second broker SIGINT: exit 0 in {dt:.2f} s with "
                   f"its flush, no jax or seaweedfs_tpu in its sys.modules")

        # 4d. the filer tools' backups and mirrors read back; every tool
        # process and filer B SIGTERMed
        ftr = _tools_reads(phase, fleet, tools, ftw, touching, smi)

        # the shell with -filer: fs.ls, fs.du, fs.cat, fs.verify
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "shell", "-master",
             fleet.master, "-filer", faddr], cwd=HERE, env=fleet.env,
            input="fs.ls /fs/wide\nfs.du /fs\nfs.cat /fs/readme.txt\n"
                  "fs.verify /fs/big\n", capture_output=True, text=True,
            timeout=CLUSTER_CALL_S)
        shell_s = time.perf_counter() - t0
        text = r.stdout
        if r.returncode != 0 or "error:" in text:
            raise AssertionError(f"{phase}: shell -filer said:\n{text}\n"
                                 f"{r.stderr[-4000:]}")
        listed = re.findall(r"(?m)^(?:> )*(s\d{5})$", text)
        want_du = (f"{sum(len(files.data(p)) for p in paths):>14d} bytes  "
                   f"{len(paths):>8d} files  /fs")
        if sorted(listed) != [p.rsplit("/", 1)[1] for p in wide] or \
                want_du not in text or files.text.decode() not in text or \
                "0 missing/corrupt" not in text:
            raise AssertionError(f"{phase}: shell -filer fs.* output does "
                                 f"not match the written set:\n"
                                 f"{text[-3000:]}")
        verified = re.search(r"verified \d+ chunks, \d+ missing/corrupt",
                             text).group(0)
        log(phase, f"shell -filer ({shell_s:.2f} s): fs.ls /fs/wide lists "
                   f"its {len(wide)} files, fs.du /fs \"{want_du.strip()}\","
                   f" fs.cat /fs/readme.txt gives its bytes, fs.verify "
                   f"/fs/big \"{verified}\"")

        # 5. the filer restarted on its sqlite store
        proc = fleet.procs["filer"][0]
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        if rc != 0:
            raise AssertionError(f"{phase}: the filer exited {rc} on SIGTERM")
        t0 = time.perf_counter()
        fport = fleet.spawn_filer("filer2", FILER_COLLECTION, fdir, fenv)
        faddr = f"127.0.0.1:{fport}"
        fleet.wait_up(["filer2"])
        restart_s = time.perf_counter() - t0
        rpc.reset_channels()
        sample = sorted(np.random.default_rng(seed + 1).choice(
            paths, size=FILER_SAMPLE, replace=False).tolist())
        for d in sorted({p.rsplit("/", 1)[0] for p in sample}):
            # the files of d (/fs holds directories beside readme.txt)
            got = sorted(f"{d}/{e.name}" for e in _filer_entries(faddr, d)
                         if not e.is_directory)
            if got != sorted(p for p in paths if p.rsplit("/", 1)[0] == d):
                raise AssertionError(f"{phase}: after the restart {d} lists "
                                     f"{len(got)} entries")
        again = _filer_get_all(phase, fport, files, sample, md5)
        log(phase, f"filer SIGTERM (exit 0) and a new one on the same -dir: "
                   f"up in {restart_s:.2f} s; the listings of a seeded "
                   f"sample's {len({p.rsplit('/', 1)[0] for p in sample})} "
                   f"directories and its {len(sample)} files byte-exact "
                   f"({_ms(again)})")

        # 6. SIGTERM to every process
        by_r = fleet.k1()
        # this master's default replication is 000: the plane wrote the
        # filer's chunks itself, untagged, and GETs of 4,096 B or more of
        # them ride sendfile on every server that held a plain volume of
        # them (the encode's sources; the master grows volumes on demand,
        # so a server may hold only shards, which Python serves)
        planes = fleet.planes()
        if not all(planes[a][2] for a in sources):
            raise AssertionError(f"{phase}: a server that held the filer's "
                                 f"plain volumes {sources} served no GET "
                                 f"by sendfile: {planes}")
        log(phase, f"every volume server on the C++ plane: (NativeDataPlane,"
                   f" NativeRequests, NativeSendfile) {planes}; 307s this "
                   f"script followed so far {dict(REDIRECTS)}")
        dirs = {n: d for n, (_, _, _, d) in fleet.procs.items()
                if n.startswith("v") and fleet.procs[n][0].poll() is None}
        rcs = fleet.terminate()
        if set(rcs.values()) != {0}:
            raise AssertionError(f"{phase}: exit codes on SIGTERM {rcs}")
        for name in ("webdav", "ftp", "iam"):
            gw.check_modules(name, rcs[name])
        dirty = [n for n, d in dirs.items()
                 if os.path.exists(recovery.marker_path(d))]
        if dirty:
            raise AssertionError(f"{phase}: dirty marker left by {dirty}")
        log(phase, f"SIGTERM: {sorted(rcs)} exited 0, no dirty marker. "
                   f"writes {total / write_s / 1e9:.3f} GB/s "
                   f"({(len(paths) + len(gone)) / write_s:.0f} files/s), "
                   f"live GETs {_ms(live_ms)}, degraded GETs {_ms(deg)}, "
                   f"encode {enc_s:.3f} s of shell wall, filer restart "
                   f"{restart_s:.2f} s; S3 PUTs "
                   f"{s3w['written'] / s3w['write_s'] / 1e9:.3f} GB/s "
                   f"({s3w['objects'] / s3w['write_s']:.0f} objects/s), S3 "
                   f"GETs after the loss {_ms(s3r['all'])}, on a lost "
                   f"shard {_ms(s3r['deg'])}, others {_ms(s3r['rest'])}, "
                   f"K1 in them {s3r['k1']}; benchmark write "
                   f"{s3w['bench'][0]:.1f} req/s, read "
                   f"{s3w['bench'][1]:.1f} req/s; the other gateways' "
                   f"writes {gwr['write_s']:.2f} s, their reads after the "
                   f"loss: " + "; ".join(
                       f"{n} on a lost shard {_ms(v['deg'])}, others "
                       f"{_ms(v['rest'])}" for n, v in gwo["ms"].items())
                   + f", K1 in them {gwo['k1']}; the filer tools' step "
                   f"{ftw['written_s']:.2f} s before the encode, its reads "
                   f"after the loss: " + "; ".join(
                       f"{n} on a lost shard {_ms(d)}, others {_ms(r)}"
                       for n, (d, r) in ftr["split"].items())
                   + f", K1 in them {ftr['k1']}; the postgres2 filer "
                   f"{pgr['files_s']:.0f} files/s, GETs after the loss on a "
                   f"lost shard {_ms(pgr['deg'])}, others "
                   f"{_ms(pgr['rest'])}, K1 in them {pgr['k1']}, listing "
                   f"{pgr['list_s']:.3f} s, restart {pgr['restart_s']:.2f} s"
                   f"; tiering: upload {tw['bytes']} B, reads after the "
                   f"loss {_ms(tr['lost_ms'])}, K1 in them {tr['k1']}, "
                   f"download {tr['down_s']:.3f} s; webdav, ftp and iam exit "
                   f"0 on SIGTERM, none with jax or seaweedfs_tpu; gf_xor "
                   f"by R over every server "
                   f"{dict(sorted(by_r.items()))}; phase wall "
                   f"{time.perf_counter() - t_phase:.3f} s; nvidia-smi: "
                   f"{smi}")
        return dict(launches=sum(by_r.values()))
    except BaseException:
        log(phase, f"log tails:\n{fleet.log_tails()}")
        raise
    finally:
        if gw is not None:
            gw.close()
        if tools is not None:
            tools.close()
        fleet.close()
        if pgf is not None:
            pgf.close()
        rpc.reset_channels()
        shutil.rmtree(root)


# -- hot ----------------------------------------------------------------------


HOT_FILES = 1000  # files of 1-64 KiB under /buckets/hot/ (the hot plane)
HOT_DIRS = 16
HOT_LARGE = 2  # files of HOT_LARGE_MIB, past the plane's 4 MiB max_body
HOT_LARGE_MIB = 8
HOT_STORM_ACKS = 400  # acknowledged PUTs of the storm before its SIGKILL
HOT_BENCH = ("-n", "2000", "-size", "4096", "-c", "8")
BENCH_LINE = re.compile(r"(?:filer )?(write|read): ([\d.]+) req/s.*? "
                        r"(\d+) failed")


def _hot_log_records(path: str) -> int:
    """Whole records in a filer hot log (41-byte header, path, mime)."""
    with open(path, "rb") as f:
        buf = f.read()
    n = off = 0
    while off + 41 <= len(buf):
        _, plen, mlen = struct.unpack_from("<BHH", buf, off)
        if off + 41 + plen + mlen > len(buf):
            break
        off += 41 + plen + mlen
        n += 1
    return n


def _bench(phase: str, fleet: _Fleet, *args: str) -> dict[str, float]:
    """`python3 -m seaweedfs_tpu_torch benchmark` -> {write|read: req/s};
    fails unless both loops ran with 0 failed."""
    r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch",
                        "benchmark", *args, *HOT_BENCH], cwd=HERE,
                       env=fleet.env, capture_output=True, text=True,
                       timeout=600)
    got = {m.group(1): (float(m.group(2)), int(m.group(3)))
           for m in BENCH_LINE.finditer(r.stdout)}
    if r.returncode or set(got) != {"write", "read"} or any(
            f for _, f in got.values()):
        raise AssertionError(f"{phase}: benchmark {args} exited "
                             f"{r.returncode}: {r.stdout[-2000:]}"
                             f"{r.stderr[-2000:]}")
    return {k: v[0] for k, v in got.items()}


def hot_phase(seed: int, workdir: str, card: str, smi: str) -> dict:
    """`python3 -m seaweedfs_tpu_torch server -filer` with the C++ planes
    (see the module docstring)."""
    phase = "hot"
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix=f"{phase}-", dir=workdir)
    fleet = _Fleet(phase, root)
    d = os.path.join(root, "data")
    os.mkdir(d)
    vport = fport = fleet.master_port
    while vport == fleet.master_port:
        vport = _free_port_pair()
    while fport in (fleet.master_port, vport):
        fport = _free_port_pair()
    faddr = f"127.0.0.1:{fport}"
    modules = os.path.join(root, "server.modules")
    args = ["server", "-dir", d, "-ip", "127.0.0.1", "-master.port",
            str(fleet.master_port), "-volume.port", str(vport), "-filer",
            "-filer.port", str(fport)]

    def start(name: str) -> float:
        t0 = time.perf_counter()
        fleet._spawn(name, args, vport, d, modules=modules)
        fleet.wait_up([name])
        while True:
            try:
                if _status(fport)["NativeHotPlane"] is not None:
                    return time.perf_counter() - t0
                raise AssertionError(f"{phase}: the filer has no hot plane")
            except OSError:
                if fleet.procs[name][0].poll() is not None:
                    raise AssertionError(f"{phase}: {name} exited")
                if time.perf_counter() - t0 > SERVER_START_S:
                    raise
                time.sleep(0.2)

    try:
        up_s = start("server")
        rng = np.random.default_rng(seed)
        payload = rng.bytes(64 * MIB)
        files = {}
        for i in range(HOT_FILES):
            size = int(rng.integers(1, 64 * 1024 + 1))
            start_at = int(rng.integers(0, len(payload) - size))
            files[f"/buckets/hot/d{i % HOT_DIRS:02d}/f{i:05d}.bin"] = (
                start_at, size)
        large = {f"/buckets/hot/large/l{i}.bin": rng.bytes(HOT_LARGE_MIB * MIB)
                 for i in range(HOT_LARGE)}

        def body_of(path: str) -> bytes:
            if path in large:
                return large[path]
            start_at, size = files[path]
            return payload[start_at:start_at + size]

        def put(conn, path):
            t0 = time.perf_counter()
            status, body, hopped = _request(conn, "PUT", path, body_of(path))
            if status != 201:
                raise AssertionError(f"{phase}: PUT {path}: {status} "
                                     f"{body[:200]!r}")
            return time.perf_counter() - t0, hopped

        h0 = _status(fport)["NativeHotPlane"]
        t0 = time.perf_counter()
        puts = _clients(fport, put, list(files))
        write_s = time.perf_counter() - t0
        large_puts = _clients(fport, put, list(large))
        h1 = _status(fport)["NativeHotPlane"]
        written = sum(s for _, s in files.values())
        log(phase, f"python3 -m seaweedfs_tpu_torch server -filer (default "
                   f"coder) up in {up_s:.2f} s; {HOT_FILES} files of 1-64 "
                   f"KiB ({written} B) PUT under /buckets/hot/ by "
                   f"{SERVER_CLIENTS} clients through the filer's public "
                   f"port in {write_s:.3f} s = {HOT_FILES / write_s:.0f} "
                   f"files/s, {written / write_s / 1e9:.3f} GB/s "
                   f"({sum(h for _, h in puts)} of them 307ed to Python); "
                   f"{HOT_LARGE} of {HOT_LARGE_MIB} MiB through Python "
                   f"({sum(h for _, h in large_puts)} 307ed); hot plane "
                   f"{ {k: h1[k] - h0[k] for k in h1} }")
        if not h1["native_puts"] - h0["native_puts"]:
            raise AssertionError(f"{phase}: the hot plane took no PUT")
        if sum(h for _, h in large_puts) != HOT_LARGE:
            raise AssertionError(f"{phase}: a PUT past max_body was not "
                                 f"sent to Python")

        def get(conn, path):
            t0 = time.perf_counter()
            status, body, hopped = _request(conn, "GET", path)
            if status != 200 or body != body_of(path):
                raise AssertionError(f"{phase}: GET {path}: {status}, "
                                     f"{len(body)} B, not the bytes written")
            return time.perf_counter() - t0, hopped

        def read_all(paths) -> tuple[list, list]:
            got = _clients(fport, get, paths)
            return ([t for t, h in got if not h], [t for t, h in got if h])

        everything = list(files) + list(large)
        hits, hops = read_all(everything)
        h2 = _status(fport)["NativeHotPlane"]
        listed = 0
        for sub in sorted({p.rsplit("/", 1)[0] for p in everything}):
            listed += len(_filer_entries(faddr, sub))
        if listed != len(everything):
            raise AssertionError(f"{phase}: the listings hold {listed} "
                                 f"entries, {len(everything)} written")
        gone = everything[0]
        conn = http.client.HTTPConnection("127.0.0.1", fport, timeout=120)
        try:
            del_status, _, del_hop = _request(conn, "DELETE", gone)
            after_del = _request(conn, "GET", gone)[0]
        finally:
            conn.close()
        if del_status not in (200, 202, 204) or after_del != 404:
            raise AssertionError(f"{phase}: DELETE {gone}: {del_status}, "
                                 f"then GET {after_del}")
        del files[gone]
        everything.remove(gone)
        log(phase, f"every file GET byte-exact by {SERVER_CLIENTS} readers: "
                   f"{len(hits)} from the hot plane ({_ms(hits)}), "
                   f"{len(hops)} 307ed to Python ({_ms(hops)}); hot plane "
                   f"{ {k: h2[k] - h1[k] for k in h2} }; the listings of "
                   f"{HOT_DIRS + 1} directories hold all {listed}; DELETE "
                   f"through Python ({'307ed' if del_hop else 'direct'}) "
                   f"{del_status}, then GET 404")

        # the CLI's compiled client loops
        bench_f = _bench(phase, fleet, "-filer", faddr)
        bench_n = _bench(phase, fleet, "-master", fleet.master,
                         "-nativeClient")
        log(phase, f"benchmark -filer {' '.join(HOT_BENCH)}: write "
                   f"{bench_f['write']:.1f} req/s, read "
                   f"{bench_f['read']:.1f} req/s; benchmark -nativeClient: "
                   f"write {bench_n['write']:.1f} req/s, read "
                   f"{bench_n['read']:.1f} req/s; 0 failed")

        # SIGKILL during a PUT storm, then a restart on the directory
        acked: dict[str, bytes] = {}
        mu = threading.Lock()
        stop = threading.Event()
        srng = np.random.default_rng(seed + 1)
        bodies = [srng.bytes(int(n)) for n in srng.integers(1, 16 * 1024,
                                                            256)]

        def storm(t):
            conn = http.client.HTTPConnection("127.0.0.1", fport, timeout=30)
            n = 0
            try:
                while not stop.is_set():
                    path = f"/buckets/crash/c{t}/f{n:06d}.bin"
                    body = bodies[(t * 31 + n) % len(bodies)]
                    n += 1
                    try:
                        status, _, _ = _request(conn, "PUT", path, body)
                    except (OSError, http.client.HTTPException):
                        return  # the server died mid-request: unacked
                    if status == 201:
                        with mu:
                            acked[path] = body
            finally:
                conn.close()

        threads = [threading.Thread(target=storm, args=(t,))
                   for t in range(SERVER_CLIENTS)]
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        while True:
            with mu:
                if len(acked) >= HOT_STORM_ACKS:
                    break
            if time.perf_counter() - t0 > 300:
                raise AssertionError(f"{phase}: the storm acked "
                                     f"{len(acked)} PUTs")
            time.sleep(0.01)
        before_kill = _plane(vport)
        h3 = _status(fport)["NativeHotPlane"]
        proc = fleet.procs["server"][0]
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        stop.set()
        for t in threads:
            t.join()
        hot_log = os.path.join(d, "filer", "filer-hot.log")
        records = _hot_log_records(hot_log)
        restart_s = start("server2")
        with mu:
            acked_now = dict(acked)
        t0 = time.perf_counter()
        lost = []

        def check(conn, path):
            status, body, _ = _request(conn, "GET", path)
            if status != 200 or body != acked_now[path]:
                lost.append((path, status))

        _clients(fport, check, list(acked_now))
        verify_s = time.perf_counter() - t0
        if lost:
            raise AssertionError(f"{phase}: {len(lost)} of {len(acked_now)} "
                                 f"acknowledged PUTs lost: {lost[:5]}")
        log(phase, f"SIGKILL during a PUT storm of {SERVER_CLIENTS} clients "
                   f"after {len(acked_now)} acknowledged PUTs (hot plane "
                   f"{h3}; {records} records in its hot log); restarted on "
                   f"the directory, the log replayed, in {restart_s:.2f} s; "
                   f"every acknowledged PUT read back byte-exact in "
                   f"{verify_s:.3f} s")

        # ec.encode of every volume the writes filled: K1 at R = 4
        vids = sorted(int(m.group(1)) for m in (
            re.fullmatch(r"(\d+)\.dat", n) for n in os.listdir(d)) if m
            and os.path.getsize(os.path.join(d, m.group(0))) > 8)
        k0 = fleet.k1()
        out, enc_s = fleet.shell("lock", *(f"ec.encode -volumeId {v}"
                                           for v in vids), "unlock")
        k1 = fleet.k1()
        step = _k1_step(k0, k1)
        if not step.get(4):
            raise AssertionError(f"{phase}: ec.encode launched K1 by R "
                                 f"{step}:\n{out}")
        left = [v for v in vids if os.path.exists(os.path.join(d, f"{v}.dat"))]
        if left:
            raise AssertionError(f"{phase}: plain volumes {left} left after "
                                 f"ec.encode:\n{out}")
        hits2, hops2 = read_all(list(files) + list(large))
        _clients(fport, check, list(acked_now))
        if lost:
            raise AssertionError(f"{phase}: after ec.encode {lost[:5]}")
        h4 = _status(fport)["NativeHotPlane"]
        log(phase, f"shell lock; ec.encode -volumeId {vids}; unlock: "
                   f"{enc_s:.3f} s, K1 launches by R {step}; every file GET "
                   f"byte-exact through the filer again: {len(hits2)} from "
                   f"the hot plane ({_ms(hits2)}), {len(hops2)} 307ed "
                   f"({_ms(hops2)}), and every acknowledged storm PUT; hot "
                   f"plane {h4}")

        by_r = fleet.k1()
        planes = fleet.planes()
        # the planes wrote these needles untagged: GETs of 4,096 B or more
        # (the filer's reads of their chunks) ride sendfile
        if not (before_kill[0] and before_kill[2] + planes[
                f"127.0.0.1:{vport}"][2]):
            raise AssertionError(f"{phase}: no GET rode sendfile: before "
                                 f"the SIGKILL {before_kill}, after {planes}")
        rcs = fleet.terminate()
        if set(rcs.values()) != {0}:
            raise AssertionError(f"{phase}: exit codes on SIGTERM {rcs}")
        _modules_clean(phase, modules,
                       "seaweedfs_tpu_torch.native.dataplane")
        if os.path.exists(recovery.marker_path(d)):
            raise AssertionError(f"{phase}: the dirty marker was not lifted")
        log(phase, f"SIGTERM: exit 0, neither jax nor seaweedfs_tpu in "
                   f"sys.modules. volume plane before the SIGKILL "
                   f"{before_kill}, after the restart {planes}; files/s "
                   f"{HOT_FILES / write_s:.0f}, GET hot {_ms(hits)}, 307ed "
                   f"{_ms(hops)}, restart {restart_s:.2f} s, benchmark "
                   f"-filer {bench_f}, -nativeClient {bench_n}; gf_xor by "
                   f"R {dict(sorted(by_r.items()))}; phase wall "
                   f"{time.perf_counter() - t_phase:.3f} s; nvidia-smi: "
                   f"{smi}")
        return dict(launches=sum(by_r.values()))
    except BaseException:
        log(phase, f"log tails:\n{fleet.log_tails()}")
        raise
    finally:
        fleet.close()
        rpc.reset_channels()
        shutil.rmtree(root)


# -- main ---------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--volume-mb", type=int, default=1024,
                    help="size of the K1 pipeline's volume (default 1024)")
    ap.add_argument("--bits-volume-mb", type=int, default=64,
                    help="size of the K2 pipeline's volume (default 64)")
    ap.add_argument("--sched-volume-mb", type=int, default=256,
                    help="size of each concurrent volume of the K3 "
                         "pipeline (default 512)")
    ap.add_argument("--sched-volumes", type=int, default=8,
                    help="volumes encoding at once in the K3 pipeline "
                         "(default 8)")
    ap.add_argument("--workdir", default=None,
                    help="where volumes are written (default: TMPDIR)")
    ap.add_argument("--baseline", default=None, metavar="DIR",
                    help="another checkout whose kernels are built and "
                         "timed beside this one's at every timed shape")
    ap.add_argument("--only", choices=tuple(KERNELS), default=None,
                    help="build, check and time this kernel alone and run "
                         "only its pipeline phase (a short loop for one "
                         "kernel; the default runs everything)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda}; "
                  f"{card}; nvidia-smi: {smi}")

    # one nvcc per library, all started together: K1, K2, and K3 once per
    # encode matrix it serves here (the scheduler phase would otherwise
    # build its matrix on the flusher thread, holding every lane)
    names = (args.only,) if args.only else tuple(KERNELS)
    if args.only:
        log("only", f"{args.only} alone: skipping the other kernels' builds, "
                    f"checks and timings and every pipeline phase but "
                    f"{PHASES[args.only]}")
    t0 = time.perf_counter()
    sel = sel_matrices() if "gf_sel" in names else {}
    # pipeline-sched runs K1 on its reconstruct lanes
    sources = tuple(src for src, users in (("gf_xor.cu", ("gf_xor", "gf_sel")),
                                           ("gf_bits.cu", ("gf_bits",)))
                    if set(users) & set(names))
    built = _build.build(sources, specialised=[
        (rs_sel.TEMPLATE, m) for m in sel.values()])
    log("build", f"nvcc built {len(built)} libraries in "
                 f"{time.perf_counter() - t0:.1f} s")
    labels = {_build.specialised_path(rs_sel.TEMPLATE, m).name:
              f"{rs_sel.TEMPLATE} for {name}{list(m.shape)}"
              for name, m in sel.items()}
    for key, b in built.items():
        text = _build.build_log(b.path)
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spills = [int(x) for x in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", text)]
        # K1's instances, C group/R pass: registers (the main path's C = 10)
        k1 = {f"{g}/{r}": int(n) for g, r, n in re.findall(
            r"gf_xor_kernelILi(\d+)ELi(\d+)E.*?Used (\d+) registers", text,
            flags=re.S) if g == "10"}
        # K2's instances: k-steps S / B fragments in registers (1) or not
        k2 = {f"{st}/{rg}": int(n) for st, rg, n in re.findall(
            r"gf_bits_kernelILi(\d+)ELb([01])E.*?Used (\d+) registers", text,
            flags=re.S)}
        by = (f"; registers by C/R {k1}" if k1 else "") + (
            f"; registers by S/in-registers {k2}" if k2 else "")
        log("build", f"{labels.get(key, key)}: {b.seconds:.1f} s; "
                     f"{len(regs)} kernels, registers {min(regs)}-"
                     f"{max(regs)}, spill bytes {sum(spills)}{by}")
        if sum(spills):
            spilled = [entry.split("'")[1] for entry in
                       text.split("Compiling entry function")[1:]
                       if re.search(r"[1-9]\d* bytes spill", entry)]
            raise AssertionError(f"{labels.get(key, key)} spills registers "
                                 f"in {spilled}")

    max_err = check_kernels(dev, names)
    baseline = None
    if args.baseline:
        t0 = time.perf_counter()
        baseline = baseline_kernels(args.baseline, args.workdir, names)
        log("build", f"baseline {', '.join(baseline)} from {args.baseline} "
                     f"in {time.perf_counter() - t0:.1f} s")
    timed = time_shapes(dev, card, baseline, names)

    paths = {}
    if "gf_xor" in names:
        paths["gf_xor"] = pipeline("pipeline", "gf_xor", args.volume_mb,
                                   seed=1, degraded=True,
                                   workdir=args.workdir, card=card)
    if "gf_bits" in names:
        paths["gf_bits"] = pipeline("pipeline-bits", "gf_bits",
                                    args.bits_volume_mb, seed=2,
                                    degraded=False, workdir=args.workdir,
                                    card=card)
    if "gf_sel" in names:
        paths["gf_sel"] = pipeline_sched(args.sched_volume_mb,
                                         args.sched_volumes, seed=3,
                                         workdir=args.workdir, card=card)
    if {"gf_xor", "gf_bits"} <= set(names):
        got = mesh_phase(seed=8, workdir=args.workdir, card=card)
        for name in ("gf_xor", "gf_bits"):
            paths[name]["launches"] += got["launches"][name]
    if "gf_xor" in names:
        got = store_phase(seed=4, workdir=args.workdir, card=card, smi=smi)
        paths["gf_xor"]["launches"] += got["launches"]
        got = server_phase(seed=5, workdir=args.workdir, card=card, smi=smi)
        paths["gf_xor"]["launches"] += got["launches"]
        got = cluster_phase(seed=6, workdir=args.workdir, card=card, smi=smi)
        paths["gf_xor"]["launches"] += got["launches"]
        got = filer_phase(seed=7, workdir=args.workdir, card=card, smi=smi)
        paths["gf_xor"]["launches"] += got["launches"]
        got = hot_phase(seed=9, workdir=args.workdir, card=card, smi=smi)
        paths["gf_xor"]["launches"] += got["launches"]

    rows = []
    for name, path in paths.items():
        spec = KERNELS[name]
        at = timed[(name, "encode [4,10]")]  # the [10, 1 MiB] encode
        rows.append(dict(
            name=name, route="cuda", source=spec["source"],
            replaces=spec["replaces"], launches=path["launches"],
            max_abs_err=max_err[name], ms=at["ms"], plain_ms=at["plain_ms"],
            bound_ms=at["bound_ms"], bound_by="bytes", library_ms=None))
    log("done", f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
