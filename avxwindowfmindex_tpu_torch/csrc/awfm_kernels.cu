// Hand-written Hopper (sm_90a) kernels for the FM-index main path.
//
// Eleven kernels, each a chain of dependent random row loads from device
// memory (a 128 B block row or a 256 B pair row for nucleotides, 256 B /
// 512 B for amino, a 384 B / 768 B n-gram pair row for n = 2 / 3) followed
// by a few dozen integer operations and __popc. The card moves memory in
// 32 B sectors, and a row's planes lie 64 B apart, so what a step costs is
// the number of sectors it asks for, not the row's width.
//
//   K1 awfm_k1_occ / awfm_k1_letter_lf, awfm_k1_step / awfm_k1_lf_at
//       Replaces avxwindowfmindex_tpu/ops/rank_pallas.py:_rank_kernel (the
//       one Pallas kernel) and ops/rank.py:_gather_rows / _count_rows /
//       letter_and_lf_from_rows. Unlike the Pallas kernel it gathers the
//       block row itself. occ(l, p) = milestone[l] + popcount(match(code(l))
//       & inclusive_mask(p % 256)); the LF mode returns the letter at p and
//       LF = C[l] + occ(l, p) - 1, sentinel -> 0, through the same LF step
//       as K3 (BlockRow). Its user is the single-query API
//       (search.py:iterative_step_backward_search and
//       backtrace_return_previous_letter_index, the reference's
//       letter-by-letter calls, one range or one position a call); the
//       seed-table BFS takes K1X, the batch modes serve the comparisons.
//       What bounds a single-query call on this card: the call, not the row.
//       Two row visits cost ~1.3 us of device time, where the batched step
//       on a one-element batch cost 340-810 us of host time a call (three
//       uploads, ~20 small launches, two synchronising readbacks). What the
//       design does about it: the step mode (k1_step_kernel) takes start,
//       end and the letter by value and computes the whole unconditional
//       step, C[l] + occ(l, start - 1) and C[l] + occ(l, end) - 1, in one
//       launch of 16 lanes (8 a row visit, both visits and C[l] asked for
//       together), writing 16 B; the LF mode by value (k1_lf_at_kernel)
//       writes (letter, LF) likewise; the wrapper keeps the checked tables,
//       the entry points and a 16 B device and pinned host buffer per view
//       (ops/kernels.py:_view_state), so a call is one launch, one 16 B
//       device-to-host copy and one synchronisation of the stream
//       (awfm_read_back): 26-58 us a call against a floor of 20-38 us for
//       an empty launch and the same readback, in one process (H100 80GB
//       HBM3, 700 W; tools.kernel_ab --cases k1, chip_smoke.py phase 7f).
//       The batch occ mode takes two lanes a position (as K1R), the
//       letter's code from the kernel's parameters and streaming loads and
//       stores: 0.227 ms for 8,388,608 pairs from 0.340 (K1w 0.42-0.44 from
//       0.53, compact 0.60 from 0.76); one lane a position with the same
//       code and stores measured 0.328 narrow and 2% behind the old body
//       wide, and is not kept.
//   K1X awfm_k1_extend
//       K1's level-extend form: one depth of the seed-table BFS
//       (ops/seed_table.py; the JAX package runs rank_pallas.py's kernel
//       under ops/seed_table.py:_extend_all_letters). Every parent range
//       (start, end) of the level is stepped by every letter without a
//       validity check: child l * n + i = (C[l] + occ(l, start - 1),
//       C[l] + occ(l, end) - 1), mod 2^32.
//       What bounds it on this card: at k = 14 and 64M bases the BFS holds
//       89M parents and writes 358M children (2.86 GB): 1.11 ms of bytes.
//       A level is in lexicographic order, so its ranges are the BWT cut
//       into consecutive pieces: neighbouring parents share their block
//       rows, and the rows cost little. What is left is integer work, a
//       match and a count a letter and a position. K1's occ mode in a
//       per-letter loop took one launch a letter and a chunk (124 at
//       k = 14) and some fifteen int64 torch passes around each: 90-98 ms
//       for the BFS, of which its launches 7.7 ms at the deepest depth.
//       What the design does about it: one launch a depth; a warp takes
//       31 consecutive parents and each lane counts every letter at ONE
//       position, the end of the parent before its own (lane 0: its
//       parent's start - 1), so each lane's end counts arrive from the next
//       lane by shuffle and its start counts are its own; a parent whose
//       start - 1 is not that end (the first of a letter's block, or a
//       table that is no BFS level) counts it itself. A count reads the
//       row's plane words and milestones once, forms the masks of its
//       local position once, and matches each letter with a compile-time
//       code (one LOP3 a word over three planes). Parents are read
//       evict-first and children stored streaming, a warp's 31 children
//       of a letter one run. 2.15 ms for the k = 14 BFS (depth 13: 1.19 ms
//       for 67M parents, 0.80 ms of bytes), from 4.19 ms for a first form
//       of one thread a parent that counted both ends (H100 80GB HBM3,
//       700 W); the compile-time codes alone gave 7% of that.
//   K1X's BFS mode awfm_k1_seed_table (awfm_k1w_seed_table,
//   awfm_k1w_compact_seed_table)
//       The same BFS, the whole table or its shallow depths, in ONE
//       cooperative launch (ops/kernels.py:k1_seed_table; the JAX package
//       runs rank_pallas.py's kernel under search64.py:_extend_level_chunked
//       for a wide view). What bounds a small table on this card: the host,
//       then the chain of depths. One launch a depth cost each depth its
//       host work (a table uploaded from pageable memory, the wrapper's
//       checks, the launch): an amino k = 5 table over the compact rows of a
//       2^26-residue index, 168,420 parents in 4 depths, took 0.22-0.28 ms
//       of host time for 0.063 ms of kernels. What the design does about it:
//       the depth-1 ranges are formed in the kernel from C[] ([C[l],
//       C[l + 1] - 1], wrapped to the width), each depth runs K1X's warp body
//       (extend_warp) over the grid, a grid barrier lies between two depths,
//       the levels between stay in one scratch allocation read and written
//       through the L2 (another SM wrote them), and the last level goes to
//       the output streaming: one ctypes call, no host table. 0.078-0.080 ms
//       for that table as a caller waits (0.071-0.073 of device time, one
//       kernel of 67-70 us), 3x faster than the per-depth route, against a
//       0.028 ms bound: its last depth (160,000 parents, 47 us) moves a 384 B
//       row a count and 51 MB of children at about 2.4 TB/s, and the three
//       depths before it are a chain of dependent row visits (5, 6.5 and
//       10.6 us, in-kernel timestamps). A block takes its runs of a depth
//       eight at a time from a counter: k = 6 amino, 64M children, 0.516 ms
//       of device time against 0.570 with a static stride; as a caller
//       waits 0.544-0.560 against 0.66-0.75 one launch a depth; at k = 5 and
//       the shallow depths of the other forms the stride was level. The
//       narrow and pair-fused forms take their depths of at most 2^18 parents
//       so (ops/seed_table.py:BFS_MAX_PARENTS): the k = 14 BFS 1.69-1.79 ms
//       from 1.97-2.23, the wide k = 13 BFS 0.80-0.83 from 1.06-1.28; past
//       that the K1X launch of one depth is ahead (77-85 registers here,
//       44-45 in K1X). Measured against it and not kept (H100 80GB HBM3,
//       700 W, in turns in one process): depths without grid barriers, each
//       run waiting on flags of the runs that wrote its parents, a warp
//       taking its runs from one counter: 1% ahead at k = 5, 1% behind at k = 6
//       and 2.3x behind on the whole k = 14 table (one atomic a run); the
//       milestones read two at a time: level; no floor of blocks an SM in
//       the launch bounds: level.
//   K2 awfm_k2_ranges
//       Replaces search.py:_seed_lookup / _initial_range, ops/rank.py:
//       backward_step and backward_step_pair, and the flag-and-rerun protocol
//       search.py:_fixup_flagged. A query is walked right to left; a step
//       reads by window class (see K4): for both ends in one block, that
//       block's sectors from its block row (planes 32 B apart, the
//       milestones after them), not from the pair row; for delta < 512,
//       the whole 512-position window of the pair row; for a wider range,
//       two block rows, so no query is re-run. An amino block row holds
//       the first-block sectors in pieces 0-2 of 64 B (0-3 from column 8),
//       where the pair row spreads them over six; a nucleotide one in two,
//       against four. Seeded queries step almost only in that class.
//       What bounds it on this card: the steps, not the seed table. Over
//       1,048,576 sampled queries of k + s letters at 64M bases, seed k = 14,
//       one thread per query took 0.055 ms + 0.064 ms x s (H100 80GB HBM3,
//       700 W): the one 8 B visit to the 2.15 GB seed table is a fourteenth
//       of a 25-mer, and a step ran at 16G a second where a walk that only
//       reads the same sectors of the pair table makes 26-28G. What the
//       design does about it: two neighbouring lanes share a query
//       (Group<2>, as K4), each loading half of every plane's sector, so a
//       warp's load instruction touches 16 sectors and not 32 and twice as
//       many row loads are in flight per query; the query's letters are read
//       once, as 4 B words into registers (QueryRow), so the milestone's
//       address does not wait for a byte load inside the dependent loop;
//       a letter's plane code comes from a table in the kernel's parameters
//       and not from memory; the seed-table entry is loaded evict-first and
//       the ranges are stored streaming. A step now runs at 22.9G a second
//       and a 25-mer batch in 0.57 ms (from 0.75). Of these, the lanes gave
//       21% and the letters 4% more; C[] and the codes staged per block in
//       shared memory gave nothing and are not kept here.
//   K3 awfm_k3_backtrace_resolve
//       Replaces search.py:backtrace_all (and its compaction schedules) and
//       _resolve_samples. Each hit is walked with LF until p % ratio == 0,
//       then resolved as (SA[p / ratio] + off) mod bwtLength in 64 bits, or
//       returned as (p, off) for a suffix array kept on disk.
//       What bounds it on this card: idle lanes, then the round trips of a
//       step; the SA visit is nothing (1,048,576 hits that need no step:
//       0.03 ms of 0.39). Walks are geometric (mean 7 steps at ratio 8), and
//       with one thread per hit a warp runs until its longest walk ends:
//       32 x the longest walk over the steps walked is 4.3, at ratio 4 as
//       at ratio 8. What the design does about it: a persistent grid in
//       which a lane whose walk has ended takes the block's next hit (a
//       warp-aggregated atomicAdd on a counter in shared memory; each block
//       owns an equal share of the hits, so no state outlives a launch),
//       and an LF step of one round trip: the planes and the milestone
//       sector of the 128 B row are asked for together before the letter is
//       known, the letter's bits are taken out of the words in registers,
//       and letter, C[], match code and milestone column come from one
//       shared-memory entry; positions and SA entries, read once, are
//       loaded evict-first. 0.33 ms for the 1,048,576 hits of the main batch
//       (from 0.39: the one round trip gave 4%, the lanes 9%, the evict-first
//       loads 4%), 2.0 ms for 8.5M hits in range order (from 2.37). What
//       keeps it from the walk's rate (32G rows a second): a lane has only
//       8 hits at 1M hits and 135,168 lanes, so the last walks run on a
//       thinning grid.
//   K4 awfm_k4_ngram_ranges
//       Replaces experiments/ab_r5_pallas_gather.py:_k2_kernel (Pallas P6,
//       the digram pair-step compute of ops/ngram.py:_pair_occ_from_rows)
//       and the host-driven n-gram step loop around it
//       (search.py:_ngram_ranges_steploop, _fixup_flagged). One query of a
//       uniform-length clean batch is walked from end to end: the seed
//       lookup, floor(m / n) n-gram steps (m = kmer_len - k) over the
//       n-gram pair rows, then the m mod n tail letters as single steps.
//       What bounds it on this card: every step is a random visit to a
//       table that outgrows the 50 MB L2 at 64M bases (250,000 x 384 B =
//       96 MB for n = 2), and a visit costs by what it asks for at two
//       levels: 32 B sectors between the L2 and the SM, and the 64 B
//       pieces in which device memory is read (chip_smoke.py's walk over a
//       1 GiB table: taking one sector of a piece instead of both saves
//       about a quarter of the visit, not half). What the design does
//       about it: a step is one of three window classes, chosen from
//       delta = end - 256 * floor((start - 1) / 256):
//         delta < 256   both counts lie in the row's first block: only
//                       words 0-7 of each plane (its first 32 B sector)
//                       and the one milestone word are loaded, 6 sectors
//                       for n = 2 and 8 for n = 3 where the whole window
//                       costs 12 and 24. At seed k = 14 a range is about
//                       one position wide, so this is 255 of 256 steps;
//         delta < 512   the whole 512-position window of one row;
//         otherwise     the first-block halves of two rows; no query is
//                       flagged or re-run.
//       K4 reads its own copy of the n-gram rows (NgramRow; ops/ngram.py:
//       k4_rows, made on the card when the index is placed there): the
//       pair layout that both packages share and the cache holds puts the
//       planes 64 B apart, so a first-block visit touched all six 64 B
//       pieces of a 384 B row for six sectors. K4's rows put the planes'
//       first sectors back to back and block b's milestones after them,
//       so the visit touches pieces 0-2 (word < 8) or 0-3: 3.5 of 6 on
//       average at n = 2, 4.9 of 12 at n = 3; the two-row class reads the
//       same first-block part of each row. K5's walk over 972,487 such
//       rows (the n = 2 table of a 249M-base index) makes 1.36-1.38 times
//       the visits a second in K4's masks as in the pair layout's; K4 at
//       64M bases went from 0.61 to 0.42 ms (n = 2) and from 0.67 to 0.49
//       (n = 3) for 1,048,576 25-mers, and at 249M bases from 3.64 to
//       2.45 ms a 4,194,304-query request (H100 80GB HBM3, 700 W).
//       The tail letters go through backward_step, which has the same
//       three classes: the first-block one over the 128 B block row (two
//       64 B pieces, where the 256 B pair row's first-block half spans
//       four), the pair window over the pair row, wider ranges over two
//       block rows; K2 reads them so too, and K2w the first-block half of
//       its pair-fused row. Two neighbouring lanes
//       share a query (Group<2>): lane j loads words [4j, 4j + 4) of each
//       plane's sector, so one load instruction of a warp touches 16
//       sectors, and the two counts are summed over the pair with a
//       shuffle; the rarer classes both lanes compute in full. The
//       seed-table entry, read once, is loaded evict-first and the ranges
//       are stored streaming (.cs), to leave the L2 to the rows. 256
//       threads a block and a budget of 128 registers a thread
//       (__launch_bounds__(256, 2)): ptxas spends them on loads started
//       early, and the kernel measured 2-3% ahead of its default choice
//       of 58 and 7% ahead of a cap of 64. The query's letters are read
//       once, as 4 B words into registers (QueryRow, as K2), where the
//       letter rows are aligned words of at most 32 letters: 0.1-1.1%
//       ahead of reading each n-gram's letters from memory between steps,
//       in both forms. Two Hopper features
//       have no use here: TMA copies tiles whose addresses follow from a
//       descriptor and a coordinate, not 32 B pieces at data-dependent
//       addresses, and there is no matrix product for wgmma.
//
//   K1w awfm_k1w_occ / awfm_k1w_letter_lf / awfm_k1w_step / awfm_k1w_lf_at, K2w awfm_k2w_ranges,
//   K3w awfm_k3w_backtrace_resolve, K1WX awfm_k1w_extend
//       The 64-bit instantiations of K1, K2, K3 and K1X, for indexes of 2^32
//       positions and more. They replace the second engine the JAX package
//       keeps for that case (ops/rank64.py: occurrence64, letter_and_lf_at64,
//       backward_step64, backward_step64_pair; search64.py: ranges64 with its
//       flag-and-rerun, backtrace_all64, _resolve_samples64), whose u64
//       values are (hi, lo) pairs of u32 lanes with explicit carries. Here a
//       position is a uint64_t. The helpers below are templates over a
//       geometry (Narrow or Wide: position type, plane stride of a block
//       row, block-index rule), so both widths share one body. The wide
//       index has ONE table of pair-fused rows with u64 milestones (256 B
//       nucleotide, 512 B amino): a step reads it by window class, as the
//       narrow step reads the pair row, and a single rank reads its
//       first-block half (the first 32 B of each 64 B plane, then the
//       milestone; K1WX counts over that half of a row, as K1X over a
//       block row, and replaces search64.py:_extend_level_chunked's
//       backward_step64). Bound like K1-K3 by dependent random row loads, from a
//       table twice as large as the narrow block rows: it outgrows the L2,
//       and the walk is bound by the 64 B pieces device memory moves. K2w
//       takes K2's design whole. K3w keeps one thread per hit and the LF
//       step of three dependent reads (lf_bytes): the persistent grid, the
//       row in registers, two lanes a hit and an L2 prefetch of the
//       milestone piece all measured level or behind there (below). A
//       nucleotide visit touches all four 64 B pieces of its pair-fused
//       row, so the walk runs near visits x 4 pieces over the memory rate
//       (0.56 ms for 7.3M steps): 0.52 ms on the 64M index forced wide
//       (64 MB, mostly in the L2), 0.74 ms on a 268 MB wide view, 0.50 ms
//       for 4.7M steps over a 4.56 GB table above 2^32 (H100 80GB HBM3,
//       700 W). Over compact rows (planes 32 B apart: two pieces a visit)
//       the same kernel takes 24-41% less (awfm_k3w_compact_backtrace_resolve),
//       the form that a wide view without pair rows takes (below). Both
//       row forms take a power-of-two ratio as a shift, as K3 does.
//   K1R awfm_k1r_occ / awfm_k1r_lf, K1Rw awfm_k1rw_occ / awfm_k1rw_lf,
//   and their route awfm_k1r_route
//       K1 over one shard of the range-sharded engine
//       (parallel/range_sharded.py), whose block rows are split by
//       contiguous block range over a list of devices. They replace the
//       masked rank the JAX package computes in XLA under shard_map
//       (parallel/range_sharded.py:_local_occurrence and the backtrace
//       segment's letter and occ; P1's arithmetic) and the psum that
//       assembles it: there every shard gets every lane of a step, answers
//       for the lanes it owns, gives 0 elsewhere, and the sum over the
//       shards is the value. Here the route (k1r_route_kernel, one
//       cooperative launch on the home device) hands each lane of a step
//       once to the shard that owns it, which follows from the position
//       alone (bits 8..39 as int32, divided by the blocks a shard): it
//       writes each routed lane's position and lane index into its shard's
//       slice of one buffer, and the totals stay on the device. A shard's
//       launch then runs its slice only and computes the step's whole
//       value there: occ(letter, pos) in occ mode; in LF mode the letter,
//       occ(min(letter, ambiguity letter), pos) and LF = C[l] + occ - 1
//       from one row visit (C[] staged per block), the lane's done rule
//       (p % ratio == 0) already taken by the route. It stores the value
//       at the lane's place in the step's output, so no sum and no unroute
//       pass follow: each lane has one writer. K1R reads the narrow block
//       rows (Narrow), K1Rw the compact wide rows (WideCompact: u64
//       milestones, planes 32 B apart) that the engine shards in place of
//       the pair-fused ones.
//       What bounds it on this card: dependent random row loads, as K1,
//       and on a shard that outgrows the L2 every visit goes to device
//       memory. The every-lane form (each shard on every lane) ran n x B
//       lanes a step for B values, and its sum, LF and done rule took some
//       2n + 10 whole-batch torch passes on the home device; its idle
//       lanes cost little (12 B read, 8 B written), the passes much. What
//       the design does about it: a step is one route pass over its B
//       lanes (8 B read, 12 B written a routed lane) and n launches that
//       run B lanes between them, on grids sized to the card that stride
//       over their slices, with no readback of the counts for a shard on
//       the home device. Two lanes share a routed position, each loading
//       half of every plane's sector and summing by shuffle, as K2's lanes
//       do: a random row visit costs by the rows a warp's load instruction
//       touches (with half of each warp idle, a launch over 2.28 GB shards
//       took 0.079 ms against 0.101 with full warps); the pair took 14% off
//       an occ step and 7-12% off an LF step. Against the every-lane form
//       in one process (H100 80GB HBM3, 700 W): an LF step over 1,048,576
//       lanes 0.081 ms against 0.198 at 2 shards, 0.116 against 0.225 on
//       two 2.28 GB shards; an occ step over 2,097,152 positions 0.120
//       against 0.100 at 2 shards and 0.147 against 0.162 at 4, the route
//       (0.028 ms) costing more than the idle lanes it saves until the
//       shards are many.
//
//   Forms for a view without pair rows (the JAX package's AWFM_PAIR_ROWS=0,
//   FmIndex.to_device(pair_rows=False) here): K2 awfm_k2_block_ranges and K4
//   awfm_k4_block_ngram_ranges (its tail steps) over the narrow block rows;
//   K1w awfm_k1w_compact_occ / _letter_lf / _step / _lf_at, K1WX awfm_k1w_compact_extend
//   and its BFS mode awfm_k1w_compact_seed_table, K2w
//   awfm_k2w_compact_ranges and K3w awfm_k3w_compact_backtrace_resolve over
//   the compact amino wide rows (384 B in place of 512 B; WideCompact).
//       The same kernels, instantiated over that layout: a step's
//       first-block class reads the block row's first-block sectors (planes
//       32 B apart, the milestones after them), and every wider range two
//       block rows, the JAX package's classic step there; no pair window.
//       A 128 B nucleotide block row holds its planes and milestones in two
//       64 B pieces, where the first-block half of a pair row spreads over
//       four, and the block rows take half the bytes (32 MB at 64M bases,
//       which the 50 MB L2 holds, against 64 MB of pair rows). A view
//       without pair rows passes a null pair table, and each launcher
//       refuses a table whose layout is not its form's. A narrow view's K1,
//       K1X and K3 read the block rows in either view.
//       The steps by class: awfm_k2_block_ranges and
//       awfm_k4_block_ngram_ranges take a pointer to two u64 counters
//       (RowSteps: both ends in one block row; read over two). ops/kernels.py
//       hands them one while a profiler records and null otherwise; the
//       entry point tests it once and launches the counting instantiation
//       (COUNT) only for a counter, so a launch with none runs the code it
//       ran before. The narrow pair-row forms, awfm_k2_ranges and
//       awfm_k4_ngram_ranges (its tail), take one in the same way: their
//       first-block steps (one block row) and the others (the pair window
//       or two block rows); so does K2w over pair-fused rows,
//       awfm_k2w_ranges, whose block rows those rows are.
//       What bounds K4 over block rows on this card: its n-gram steps. The
//       n = 2 rows (96 MB) lie beyond the L2, and K5's walk over their
//       first-block sectors alone (192 B a visit) runs at 17.5G visits a
//       second, 3.35 TB/s of sectors; K4 makes its 5.2M n-gram visits at
//       about 0.65 of that rate, beside the 32 MB block rows and the seed
//       table in the same L2, and stands at 1.41 of a model that charges
//       every visit at its table's walked rate (tools.kernel_ab --cases
//       pairless). What the design does: the letters in registers (K4's
//       note). Measured against it in one process and not kept (H100 80GB
//       HBM3, 700 W): an evict-last L2 policy (createpolicy.fractional)
//       on the block rows beside a share of the n-gram rows, 1-4% behind;
//       on a share of the n-gram rows sized to the L2 alone, 1-2% behind;
//       two queries a lane pair, their first-block loads asked for
//       together and the rarer classes out of line, 3% behind at n = 2 and
//       13% at n = 3 (128 registers and spills): the visits in flight were
//       not what held it.
//       What bounds K2w over compact rows: the same walk over the 100.7 MB
//       amino rows runs at 20G visits a second (the five plane sectors and
//       a milestone sector, 192 B), and K2w makes its 7.46M visits at
//       1.06-1.10 of that model. It keeps K2's form (K2's note); measured against
//       it and not kept: an evict-last share of the plane sectors sized to
//       36 MB, 7% behind; the milestone loaded by one lane of the pair and
//       shuffled, level; one lane a query (five whole plane sectors a
//       lane), 33% behind.
//       What bounds K2 over block rows: the L2's rate of row visits. The
//       32 MB rows stay in the L2, and K5's walk over their four sectors a
//       visit runs at about 32G visits a second with one lane a chain and
//       about twice that with four (each lane a share of the row's pieces;
//       a warp load instruction then touches 8 rows; two lanes gain only
//       5-10%): the block rows' ceiling, its readings in PERF.md section 6.
//       K2's steps make their 11.6M visits at about 57G a second, and the
//       launch stands at about 1.1-1.3 of a model at the four-lane rate
//       plus a launch that makes the seed-table visits and no step. It
//       keeps K2's form; measured against it and not kept
//       (H100 80GB HBM3, 700 W, each in turns in one process): a grid the
//       card holds at once whose lane pairs walk queries in turn, asking
//       for the next query's letters (into the L2 a turn ahead) and
//       seed-table entry before stepping the current one, 40-57% behind
//       with the entry in registers (74 registers), 18-19% behind with it
//       prefetched into the L2 and loaded at its turn, 16-55% behind at 4
//       or 5 blocks an SM (64 and 48 registers); four lanes a query, 54%
//       behind; this form held to 6 and 8 blocks an SM (40 and 32
//       registers, spills), 16% and 45% behind. Fewer queries in flight
//       cost more than the seed visits the grid hides.
//       What bounds K3w over compact rows: the 100.7 MB rows lie beyond
//       the L2, and the walk's 7.35M LF steps, 3.8 pieces of 64 B each,
//       move near the memory rate with the table's share in the L2: 1.48-
//       1.56 of a model at the rows' calibrated 19.2-19.4G visits a second
//       (a walk that asks for a visit's sectors in one round trip). One
//       thread a hit keeps a lane busy 23% of its warp's time (mean steps
//       over the warp's longest walk) and the grid that hands out hits 68%,
//       yet every grid form measured behind (in turns in one process):
//       the block row's five plane sectors as 40 words, then the
//       milestone, 4% behind and 12% in the on-disk form (76 registers, 3
//       blocks an SM); lf_bytes in the grid, 27% (38 registers: a full
//       grid's plane sectors outgrow the L1 between its dependent reads);
//       an L2 prefetch of the milestone pieces beside the plane loads, 28%
//       (five pieces a step in place of 3.8); the plane sectors copied to
//       shared memory by cp.async, 22-25% (47-53 registers); the block-row
//       form held to 4 or 5 blocks an SM, 20% and 160% (spills). Nor did
//       one thread a hit gain from the first milestone sector asked for
//       beside the plane bytes (6% behind) or from 8 blocks an SM (32
//       registers, 7-8% behind). Busier lanes did not walk faster: beyond
//       the L2 the pieces a step moves, not idle lanes, set the pace. Kept:
//       one thread a hit, a power-of-two ratio taken as a shift (p % ratio
//       in u64 is a software routine on this card), about 1% ahead.
//
// Semantics follow the JAX package bit for bit. Narrow positions are u32 and
// wrap mod 2^32 (start - 1 at start == 0 is 0xFFFFFFFF); a block index past
// the table clamps to the last row, as XLA's gather does. Wide positions are
// u64 and wrap mod 2^64; their block index is the low 32 bits of pos >> 8
// read as int32, a negative value counted from the end of the table, then
// clamped to the table (ops/rank64.py:_gather_rows64 under JAX's indexing
// rule), so start - 1 at start == 0 reads the last row there too. The letter
// selects are one-hot, so a letter above the alphabet's ambiguity index has
// code 0 and milestone 0, and one above the sentinel has C = 0.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (avxwindowfmindex_tpu_torch/ops/kernels.py).
// Every entry point returns cudaGetLastError() after its launch, but
// awfm_read_back, the single-query calls' readback, which copies 16 B to
// pinned host memory on the stream and synchronises that stream.

#include <cstdint>
#include <cuda_runtime.h>

#include "awfm_common.cuh"

extern "C" {
// Mirrored by ops/kernels.py:_Tables (ctypes.Structure).
struct AwfmTables {
  const uint8_t* packed;        // (nb, row_bytes) fused block rows
  const uint8_t* packed_pair;   // (nb, pair_row_bytes) pair rows (wide: packed itself)
  const void* prefix_sums;      // (card + 2) C[] with C[0] = 1: u32, or u64 (wide)
  const uint8_t* code_masks;    // (card + 2, n_planes) 0xFF / 0x00
  int64_t nb;
  int32_t row_bytes;
  int32_t pair_row_bytes;
  int32_t card;
  int32_t n_planes;
  // models/index.py:kernel_letter_tables, staged per block (BlockConsts)
  // 32 bytes each, byte i in bits 8 (i % 8) .. of word i / 8
  uint64_t letter_code[4];  // letter -> plane code; 0 above the ambiguity letter
  uint64_t code_letter[4];  // plane code -> letter (vec_to_index); 0 past 2^n_planes
};

// Mirrored by ops/kernels.py:_NgramTables (ctypes.Structure).
struct NgramTables {
  const uint8_t* packed;  // (nb, row_bytes) n-gram rows in K4's layout (NgramRow)
  const uint32_t* cn;     // (4^n) n-mer range starts
  int64_t nb;
  int32_t row_bytes;      // 384 (n = 2) or 768 (n = 3)
  int32_t n;
  int32_t biased;         // milestones already hold Cn[w] + occ
};
}

namespace {

constexpr int kThreads = 256;

// K1R's occ mode takes a letter's plane code from code_masks: a rank is too
// short to pay for a block's staging, and the table in the kernel's
// parameters measured 2.5% behind on wide rows in K1's first occ form (one
// thread a position). K1's occ mode now takes it from the parameters.
__device__ __forceinline__ uint32_t code_of_letter(const AwfmTables& t, int np,
                                                   uint32_t l) {
  if (l > static_cast<uint32_t>(t.card)) return 0u;
  uint32_t c = 0u;
  for (int i = 0; i < np; ++i) {
    c |= (t.code_masks[l * np + i] ? 1u : 0u) << i;
  }
  return c;
}

// Row geometry and position arithmetic of the two index widths.
struct Narrow {
  using pos_t = uint32_t;
  static constexpr int kStride = 32;  // plane stride of a block row
  // past the table: the last row
  static __device__ __forceinline__ int64_t block(int64_t nb, pos_t pos) {
    const int64_t blk = static_cast<int64_t>(pos >> 8);
    return blk < nb - 1 ? blk : nb - 1;
  }
};

struct Wide {
  using pos_t = uint64_t;
  static constexpr int kStride = 64;  // block rows are the pair rows
  // bits 8..39 of pos as int32; negative: from the end; then clamped
  static __device__ __forceinline__ int64_t block(int64_t nb, pos_t pos) {
    int64_t blk = static_cast<int32_t>(static_cast<uint32_t>(pos >> 8));
    if (blk < 0) blk += nb;
    return blk < 0 ? 0 : (blk < nb - 1 ? blk : nb - 1);
  }
};

// The compact wide rows a range-sharded engine shards
// (models/index.py:pack_device_blocks64(pair=False)): Wide's positions,
// milestones and block-index rule over single-block rows, planes 32 B apart.
struct WideCompact : Wide {
  static constexpr int kStride = 32;
};

// What a step needs to know of a letter: its C[] term and, packed in
// `meta`, the plane code to match (bits 0-7), the letter itself (8-15), its
// milestone column (16-23) and a flag (24): for a backward step, the letter
// has a milestone (it is not above the ambiguity letter); for an LF step,
// the position does not hold the sentinel.
template <class P>
struct alignas(2 * sizeof(P)) LetterEntry {
  P c;
  uint32_t meta;
  __device__ __forceinline__ uint32_t code() const { return meta & 255u; }
  __device__ __forceinline__ uint32_t letter() const { return (meta >> 8) & 255u; }
  __device__ __forceinline__ uint32_t column() const { return (meta >> 16) & 255u; }
  __device__ __forceinline__ bool flag() const { return (meta >> 24) != 0u; }
};

// What an LF step needs, staged once per block in shared memory so that
// nothing between a row's arrival and the next address touches global
// memory: by_code[c] serves a position whose planes spell code c with the
// letter there, and C, match code and milestone column of min(letter,
// ambiguity letter), in one 8 B or 16 B entry.
template <class P>
struct BlockConsts {
  LetterEntry<P> by_code[32];
};

// Byte i < 32 of a table passed by value (selects: a dynamic index would
// copy the kernel's parameters to local memory).
__device__ __forceinline__ uint32_t table_byte(const uint64_t (&w)[4], uint32_t i) {
  const uint32_t k = i >> 3;
  const uint64_t word = k == 0u ? w[0] : (k == 1u ? w[1] : (k == 2u ? w[2] : w[3]));
  return static_cast<uint32_t>(word >> ((i & 7u) * 8u)) & 255u;
}

// Every thread of the block calls this before any of them leaves.
template <class G>
__device__ __forceinline__ void stage_consts(
    const AwfmTables& t, BlockConsts<typename G::pos_t>& s) {
  using pos_t = typename G::pos_t;
  const uint32_t i = threadIdx.x;
  if (i < 32u) {
    const uint32_t card = static_cast<uint32_t>(t.card);
    const uint32_t lett = table_byte(t.code_letter, i);
    const uint32_t col = lett < card ? lett : card;
    LetterEntry<pos_t> e;
    e.c = static_cast<const pos_t*>(t.prefix_sums)[col];
    e.meta = table_byte(t.letter_code, col) | (lett << 8) | (col << 16) |
             ((lett != card + 1u ? 1u : 0u) << 24);
    s.by_code[i] = e;
  }
  __syncthreads();
}

// What a backward step by letter l needs: C[] from global memory, the
// code from the table in the kernel's parameters. (Staged in shared memory
// instead, it measured level in K2 and, for the barrier, 5% behind in K4.)
template <class G>
__device__ __forceinline__ LetterEntry<typename G::pos_t> letter_entry(
    const AwfmTables& t, uint32_t l) {
  using pos_t = typename G::pos_t;
  const uint32_t card = static_cast<uint32_t>(t.card);
  LetterEntry<pos_t> e;
  e.c = l <= card + 1u ? static_cast<const pos_t*>(t.prefix_sums)[l] : 0;
  e.meta = table_byte(t.letter_code, l < 31u ? l : 31u) | (l << 16) |
           ((l <= card ? 1u : 0u) << 24);
  return e;
}

// The milestone of an entry's column in a row whose milestones start at
// row + ms_off; 0 for a letter that has none.
template <class G>
__device__ __forceinline__ typename G::pos_t milestone(
    const uint8_t* row, int ms_off, const LetterEntry<typename G::pos_t>& e) {
  if (!e.flag()) return 0;
  return reinterpret_cast<const typename G::pos_t*>(row + ms_off)[e.column()];
}

// W consecutive plane words (W = 1, 2, or a multiple of 4) from a pointer
// aligned to their size, as the widest loads that cover them.
template <int W>
__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t (&x)[W]) {
  if constexpr (W == 1) {
    x[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
  } else if constexpr (W == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    x[0] = v.x;
    x[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + q);
      x[4 * q + 0] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  }
}

// Match words of one row: bit p of word w is set iff the letter at local
// position 32 * w + p has `code`. W = 8 words per plane for one block,
// 16 for a pair; planes lie STRIDE bytes apart (32 in a narrow block row,
// 64 in a pair row and in every wide row). `row` may point into the
// planes: a lane of a group passes the offset of its own words.
template <int NP, int W, int STRIDE>
__device__ __forceinline__ void match_words(const uint8_t* row, uint32_t code,
                                            uint32_t (&m)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) m[w] = 0u;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const uint32_t cm = ((code >> i) & 1u) ? 0xFFFFFFFFu : 0u;
    uint32_t x[W];
    load_words<W>(row + i * STRIDE, x);
#pragma unroll
    for (int w = 0; w < W; ++w) m[w] |= x[w] ^ cm;
  }
#pragma unroll
  for (int w = 0; w < W; ++w) m[w] = ~m[w];
}

// Set bits of m at local positions 0..local inclusive; m[0] is word
// `base` of the window (a lane of a group holds words base .. base + W - 1).
template <int W>
__device__ __forceinline__ uint32_t count_inclusive(const uint32_t (&m)[W],
                                                    uint32_t local,
                                                    uint32_t base = 0u) {
  const uint32_t lw = local >> 5;
  const uint32_t low = (2u << (local & 31u)) - 1u;  // 2u << 31 wraps to 0
  uint32_t c = 0u;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t uw = base + static_cast<uint32_t>(w);
    const uint32_t mask = uw < lw ? 0xFFFFFFFFu : (uw == lw ? low : 0u);
    c += __popc(m[w] & mask);
  }
  return c;
}

// A group of G neighbouring lanes (G = 1, 2, 4 or 8) that shares one query.
template <int G>
struct Group {
  int sub;        // this lane's place in its group
  uint32_t mask;  // the group's lanes within the warp
  __device__ __forceinline__ Group() {
    const int lane = threadIdx.x & 31;
    sub = lane & (G - 1);
    mask = G == 1 ? 0u : ((1u << G) - 1u) << (lane & ~(G - 1));
  }
  // the sum of c over the group, in every lane of it
  __device__ __forceinline__ uint32_t sum(uint32_t c) const {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) c += __shfl_xor_sync(mask, c, o);
    return c;
  }
};

// occ at pos, inclusive, of the letter with plane code `code` and, if it
// has one, the milestone column `col`: one block row.
template <class G, int NP>
__device__ __forceinline__ typename G::pos_t occ_at(
    const AwfmTables& t, typename G::pos_t pos, uint32_t code, bool has_ms,
    uint32_t col) {
  using pos_t = typename G::pos_t;
  const uint8_t* row = t.packed + G::block(t.nb, pos) * t.row_bytes;
  uint32_t m[8];
  match_words<NP, 8, G::kStride>(row, code, m);
  const pos_t ms =
      has_ms ? reinterpret_cast<const pos_t*>(row + NP * G::kStride)[col] : 0;
  return ms + count_inclusive<8>(m, static_cast<uint32_t>(pos) & 255u);
}

// Milestone column col of the kMs milestones held in uint4 words, by
// selects (a dynamic index would put the words in local memory).
template <class P, int kMs, int kVec>
__device__ __forceinline__ P select_milestone(const uint4 (&ms)[kVec], uint32_t col) {
  P v = 0;
#pragma unroll
  for (int e = 0; e < kMs; ++e) {
    P cand;
    if constexpr (sizeof(P) == 4) {
      const uint4 q = ms[e / 4];
      cand = e % 4 == 0 ? q.x : (e % 4 == 1 ? q.y : (e % 4 == 2 ? q.z : q.w));
    } else {
      const uint4 q = ms[e / 2];
      cand = e % 2 == 0 ? (static_cast<uint64_t>(q.y) << 32) | q.x
                        : (static_cast<uint64_t>(q.w) << 32) | q.z;
    }
    v = col == static_cast<uint32_t>(e) ? cand : v;
  }
  return v;
}

// A block row as an LF step needs it, in registers: the 8 words of each
// plane and the milestones, asked for together before the letter at the
// position is known, so a step is one round trip to memory. That holds
// where the milestones lie in the sector the planes leave of the row's
// last 64 B piece, the narrow nucleotide row. An amino row's 21 milestones
// span three sectors and a wide nucleotide row's two, and asking for them
// all measured behind the planes first and then the one milestone.
template <class G, int NP>
struct BlockRow {
  using pos_t = typename G::pos_t;
  static constexpr int kMs = NP == 3 ? 5 : 21;  // card + 1 milestones
  static constexpr bool kUpFront = NP == 3 && sizeof(pos_t) == 4;
  static constexpr int kMsVec =
      kUpFront ? (kMs * static_cast<int>(sizeof(pos_t)) + 15) / 16 : 1;
  uint32_t x[NP][8];
  uint4 ms[kMsVec];
  const uint8_t* row;

  __device__ __forceinline__ void load(const AwfmTables& t, pos_t pos) {
    row = t.packed + G::block(t.nb, pos) * t.row_bytes;
#pragma unroll
    for (int i = 0; i < NP; ++i) load_words<8>(row + i * G::kStride, x[i]);
    if constexpr (kUpFront) {
#pragma unroll
      for (int q = 0; q < kMsVec; ++q) {
        ms[q] = __ldg(reinterpret_cast<const uint4*>(row + NP * G::kStride) + q);
      }
    }
  }

  // the plane code of the letter at block-local position `local`
  __device__ __forceinline__ uint32_t code_at(uint32_t local) const {
    const uint32_t w = local >> 5, bit = local & 31u;
    uint32_t code = 0u;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      uint32_t word = x[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) word = w == static_cast<uint32_t>(j) ? x[i][j] : word;
      code |= ((word >> bit) & 1u) << i;
    }
    return code;
  }

  // milestone of column col <= card, by selects over the loaded words
  __device__ __forceinline__ pos_t milestone_of(uint32_t col) const {
    if constexpr (!kUpFront) {
      return reinterpret_cast<const pos_t*>(row + NP * G::kStride)[col];
    } else {
      return select_milestone<pos_t, kMs>(ms, col);
    }
  }

  // occ at block-local position `local`, inclusive, of the letter whose
  // match code and milestone column entry e gives
  __device__ __forceinline__ pos_t occ(const LetterEntry<pos_t>& e,
                                       uint32_t local) const {
    const uint32_t code = e.code();
    uint32_t m[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) m[w] = 0u;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const uint32_t cm = ((code >> i) & 1u) ? 0xFFFFFFFFu : 0u;
#pragma unroll
      for (int w = 0; w < 8; ++w) m[w] |= x[i][w] ^ cm;
    }
#pragma unroll
    for (int w = 0; w < 8; ++w) m[w] = ~m[w];
    return milestone_of(e.column()) + count_inclusive<8>(m, local);
  }

  // LF(pos) from the loaded row, and the letter at pos
  __device__ __forceinline__ pos_t lf(const BlockConsts<pos_t>& s, pos_t pos,
                                      uint32_t* letter) const {
    const uint32_t local = static_cast<uint32_t>(pos) & 255u;
    const LetterEntry<pos_t> e = s.by_code[code_at(local)];
    *letter = e.letter();
    if (!e.flag()) return 0;  // sentinel
    return e.c + occ(e, local) - 1u;
  }
};

// One backward step of a valid range (start <= end) by letter l, by window
// class. The lanes of a group hold the same range and share the loads of
// the first-block class; the rarer classes each lane computes in full.
// The first-block class reads the block row in every form (t.packed,
// planes G::kStride apart, the milestones after them; a wide view's block
// rows are its pair-fused rows): a narrow amino row holds its sectors in
// 3-4 of its 64 B pieces, where the pair row's first-block half spreads
// over 6. PAIR selects only the rest: the 512-position window of the pair
// row (t.packed_pair) for delta < 512; else, for a view without pair rows,
// every wider range over two block rows, the step the JAX package takes
// there (ops/rank.py:backward_step over P1's rank). t.packed_pair is null
// in such a view, so no form of it reads a pair row. Returns whether the
// step took the first-block class (one row; else the pair window or two
// rows).
template <class G, int NP, int GL = 1, bool PAIR = true>
__device__ __forceinline__ bool backward_step(
    const AwfmTables& t, const LetterEntry<typename G::pos_t>& e,
    typename G::pos_t& start, typename G::pos_t& end,
    const Group<GL>& grp = Group<GL>()) {
  using pos_t = typename G::pos_t;
  const uint32_t code = e.code();
  const pos_t pos_s = start - 1u;
  // unsigned compare at the full position width (ops/rank.py:382-388,
  // ops/rank64.py:470-472)
  const pos_t delta = end - (pos_s & ~static_cast<pos_t>(255));
  const bool first = delta < 256u;
  pos_t occ_s, occ_e;
  if (first) {
    // both ends in the first block: words 0-7 of each plane, one milestone
    constexpr int W = 8 / GL;
    constexpr int S = G::kStride;
    const uint8_t* row = t.packed + G::block(t.nb, pos_s) * t.row_bytes;
    uint32_t m[W];
    match_words<NP, W, S>(row + grp.sub * (4 * W), code, m);
    const pos_t ms = milestone<G>(row, NP * S, e);
    const uint32_t base = grp.sub * W;
    occ_s = ms + grp.sum(count_inclusive<W>(
                     m, static_cast<uint32_t>(pos_s) & 255u, base));
    occ_e = ms + grp.sum(count_inclusive<W>(m, static_cast<uint32_t>(delta), base));
  } else if (PAIR && delta < 512u) {
    const uint8_t* row =
        t.packed_pair + G::block(t.nb, pos_s) * t.pair_row_bytes;
    uint32_t m[16];
    match_words<NP, 16, 64>(row, code, m);
    const pos_t ms = milestone<G>(row, NP * 64, e);
    occ_s = ms + count_inclusive<16>(m, static_cast<uint32_t>(pos_s) & 255u);
    occ_e = ms + count_inclusive<16>(m, static_cast<uint32_t>(delta));
  } else {
    occ_s = occ_at<G, NP>(t, pos_s, code, e.flag(), e.column());
    occ_e = occ_at<G, NP>(t, end, code, e.flag(), e.column());
  }
  start = e.c + occ_s;
  end = e.c + occ_e - 1u;
  return first;
}

// The steps of a launch by class (COUNT): counts[0] the first-block steps,
// which read one block row, counts[1] the others: over two block rows in a
// form without pair rows, the pair window or two block rows in a pair form
// and in K2w over pair-fused rows (awfm.blockrows.* and awfm.pairrows.* in
// ops/kernels.py). A lane counts its query's steps in registers (the first
// lane of a group alone: its lanes take the same steps) and the lanes of a
// warp still running add their sums once, by its lowest lane.
struct RowSteps {
  uint32_t one = 0u, two = 0u;

  __device__ __forceinline__ void add(bool first, int sub) {
    if (sub != 0) return;
    one += first ? 1u : 0u;
    two += first ? 0u : 1u;
  }

  __device__ __forceinline__ void flush(unsigned long long* counts) const {
    const unsigned int lanes = __activemask();
    const uint32_t a = __reduce_add_sync(lanes, one);
    const uint32_t b = __reduce_add_sync(lanes, two);
    if ((threadIdx.x & 31u) == static_cast<unsigned int>(__ffs(lanes) - 1)) {
      atomicAdd(counts, static_cast<unsigned long long>(a));
      atomicAdd(counts + 1, static_cast<unsigned long long>(b));
    }
  }
};

// K4's layout of an n-gram pair row (ops/ngram.py:_geometry_k4), from N
// alone: the first 32 B of each of the 2N + 1 planes (block b's words 0-7)
// back to back from byte 0, block b's 4^N milestone words at kMs, the
// second 32 B of each plane (block b+1's) at kHi, padded to 128 B. A
// first-block visit thus reads bytes [0, kMs) and one milestone word,
// adjacent 64 B pieces.
template <int N>
struct NgramRow {
  static constexpr int kPlanes = 2 * N + 1;
  static constexpr int kMs = 32 * kPlanes;                // 160, 224
  static constexpr int kHi = kMs + 4 * (1 << (2 * N));    // 224, 480
  static constexpr int kBytes = (kHi + kMs + 127) / 128 * 128;  // 384, 768
};

// Match words of an n-gram row for word value v: bit p of word w is set
// iff the n-gram code at pair-local position 32 * w + p equals v. Planes
// 0..2N-1 hold the code's value bits and are XORed with bit i of v; plane
// 2N marks dirty words and is ORed in as it is (P6's match). W = 16 covers
// the 512-position window (words 8-15 at kHi), W = 8 the first block only,
// fewer a group lane's share of it (`row` then points at the lane's words).
template <int N, int W>
__device__ __forceinline__ void ngram_match_words(const uint8_t* row,
                                                  uint32_t v,
                                                  uint32_t (&m)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) m[w] = 0u;
#pragma unroll
  for (int i = 0; i <= 2 * N; ++i) {
    const uint32_t cm = (i < 2 * N && ((v >> i) & 1u)) ? 0xFFFFFFFFu : 0u;
    uint32_t x[W];
    if constexpr (W == 16) {
      uint32_t lo[8], hi[8];
      load_words<8>(row + i * 32, lo);
      load_words<8>(row + NgramRow<N>::kHi + i * 32, hi);
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        x[w] = lo[w];
        x[8 + w] = hi[w];
      }
    } else {
      load_words<W>(row + i * 32, x);
    }
#pragma unroll
    for (int w = 0; w < W; ++w) m[w] |= x[w] ^ cm;
  }
#pragma unroll
  for (int w = 0; w < W; ++w) m[w] = ~m[w];
}

// Block milestone of word v (Cn-biased or not, as stored); 0 outside
// [0, 4^N), as the one-hot select of the JAX package gives.
template <int N>
__device__ __forceinline__ uint32_t ngram_milestone(const uint8_t* row,
                                                    uint32_t v) {
  constexpr uint32_t kWords = 1u << (2 * N);
  if (v >= kWords) return 0u;
  return *reinterpret_cast<const uint32_t*>(row + NgramRow<N>::kMs + 4 * v);
}

// occn(v, pos) inclusive, from the first-block half of pos's pair row.
template <int N>
__device__ __forceinline__ uint32_t ngram_occ_at(const NgramTables& g,
                                                 uint32_t pos, uint32_t v) {
  const uint8_t* row = g.packed + Narrow::block(g.nb, pos) * g.row_bytes;
  uint32_t m[8];
  ngram_match_words<N, 8>(row, v, m);
  return ngram_milestone<N>(row, v) + count_inclusive<8>(m, pos & 255u);
}

// One n-gram backward step of a valid range (start <= end) by word v, by
// window class; the lanes of a group as in backward_step.
template <int N, int GL>
__device__ __forceinline__ void ngram_step(const NgramTables& g,
                                           uint32_t& start, uint32_t& end,
                                           uint32_t v, const Group<GL>& grp) {
  constexpr uint32_t kWords = 1u << (2 * N);
  const uint32_t cn = (g.biased || v >= kWords) ? 0u : g.cn[v];
  const uint32_t pos_s = start - 1u;
  // unsigned compare before any narrowing (ops/ngram.py:627-631)
  const uint32_t delta = end - (pos_s & ~255u);
  uint32_t occ_s, occ_e;
  if (delta < 256u) {
    // both ends in the first block: the first sector of each plane and the
    // milestone word (_pair_occ_from_rows with no mask bit in words 8-15)
    constexpr int W = 8 / GL;
    const uint8_t* row = g.packed + Narrow::block(g.nb, pos_s) * g.row_bytes;
    uint32_t m[W];
    ngram_match_words<N, W>(row + grp.sub * (4 * W), v, m);
    const uint32_t ms = ngram_milestone<N>(row, v);
    const uint32_t base = grp.sub * W;
    occ_s = ms + grp.sum(count_inclusive<W>(m, pos_s & 255u, base));
    occ_e = ms + grp.sum(count_inclusive<W>(m, delta, base));
  } else if (delta < 512u) {
    const uint8_t* row = g.packed + Narrow::block(g.nb, pos_s) * g.row_bytes;
    uint32_t m[16];
    ngram_match_words<N, 16>(row, v, m);
    const uint32_t ms = ngram_milestone<N>(row, v);
    occ_s = ms + count_inclusive<16>(m, pos_s & 255u);
    occ_e = ms + count_inclusive<16>(m, delta);
  } else {
    occ_s = ngram_occ_at<N>(g, pos_s, v);
    occ_e = ngram_occ_at<N>(g, end, v);
  }
  start = cn + occ_s;
  end = cn + occ_e - 1u;
}

// A query's letters. QueryRow<0> reads them from its row of the letter matrix
// as they are needed; QueryRow<LW> holds the first 4 * LW of them in registers,
// read once as 4 B words before the first step (the matrix rows are a
// multiple of 4 B long), so that no load but a table row's stands between
// two steps.
template <int LW>
struct QueryRow {
  uint32_t w[LW];
  __device__ __forceinline__ QueryRow(const uint8_t* row, int64_t l_pad) {
#pragma unroll
    for (int i = 0; i < LW; ++i) {
      w[i] = 4 * i < l_pad ? __ldg(reinterpret_cast<const uint32_t*>(row) + i) : 0u;
    }
  }
  __device__ __forceinline__ uint32_t operator[](int64_t c) const {
    const uint32_t wi = static_cast<uint32_t>(c) >> 2;
    uint32_t word = w[0];
#pragma unroll
    for (int i = 1; i < LW; ++i) word = wi == static_cast<uint32_t>(i) ? w[i] : word;
    return (word >> ((static_cast<uint32_t>(c) & 3u) * 8u)) & 255u;
  }
};

template <>
struct QueryRow<0> {
  const uint8_t* row;
  __device__ __forceinline__ QueryRow(const uint8_t* r, int64_t) : row(r) {}
  __device__ __forceinline__ uint32_t operator[](int64_t c) const { return row[c]; }
};

// Seed-table range of the last k letters of a query of length len: the
// base-|A| radix, leftmost most significant, clamped to the table. The
// entry is read once, so it is loaded evict-first (ld.global.cs) and does
// not push table rows out of the L2.
template <class P, class Q>
__device__ __forceinline__ void seed_range(const P* seed_table,
                                           int64_t seed_rows, int k,
                                           uint32_t card, const Q& row,
                                           int64_t len, int64_t l_pad,
                                           P& start, P& end) {
  uint32_t idx = 0u;
  for (int j = 0; j < k; ++j) {
    int64_t c = len - k + j;
    c = c < 0 ? 0 : (c >= l_pad ? l_pad - 1 : c);
    idx = idx * card + row[c];
  }
  const int64_t r = static_cast<int64_t>(idx) < seed_rows
                        ? static_cast<int64_t>(idx)
                        : seed_rows - 1;
  if constexpr (sizeof(P) == 4) {
    const uint2 v = __ldcs(reinterpret_cast<const uint2*>(seed_table) + r);
    start = v.x;
    end = v.y;
  } else {
    const ulonglong2 v = __ldcs(reinterpret_cast<const ulonglong2*>(seed_table) + r);
    start = v.x;
    end = v.y;
  }
}

__device__ __forceinline__ void store_range(int64_t* start_out, int64_t* end_out,
                                            int64_t q, uint64_t start, uint64_t end) {
  __stcs(reinterpret_cast<long long*>(start_out + q), static_cast<long long>(start));
  __stcs(reinterpret_cast<long long*>(end_out + q), static_cast<long long>(end));
}

template <class G, int NP>
__global__ void k1_letter_lf_kernel(AwfmTables t,
                                    const int64_t* __restrict__ pos, int64_t n,
                                    int32_t* __restrict__ letters_out,
                                    int64_t* __restrict__ lf_out) {
  using pos_t = typename G::pos_t;
  __shared__ BlockConsts<pos_t> s;
  stage_consts<G>(t, s);
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const pos_t p = static_cast<pos_t>(pos[i]);
  BlockRow<G, NP> r;
  r.load(t, p);
  uint32_t lett;
  lf_out[i] = static_cast<int64_t>(r.lf(s, p, &lett));
  letters_out[i] = static_cast<int32_t>(lett);
}

// K1R / K1Rw over one shard of a range-sharded engine, and the route that
// hands each position of a step to the shard that owns it (module note).
constexpr int kRouteMaxShards = 128;
// Lanes that share one routed position in K1R's launches: each loads half
// of every plane's 32 B sector, so a warp's load instruction touches 16
// rows and not 32 (as K2's group; a random row visit costs by the rows an
// instruction touches, not only by the sectors it asks for).
constexpr int kK1RGroup = 2;

// occ_at for a group of GL lanes that share pos: lane sub loads words
// [W sub, W (sub + 1)) of each plane (W = 8 / GL) and the milestone, and
// every lane of the group returns the occ.
template <class G, int NP, int GL>
__device__ __forceinline__ typename G::pos_t occ_at_group(
    const AwfmTables& t, typename G::pos_t pos, uint32_t code, bool has_ms,
    uint32_t col, const Group<GL>& grp) {
  using pos_t = typename G::pos_t;
  constexpr int W = 8 / GL;
  const uint8_t* row = t.packed + G::block(t.nb, pos) * t.row_bytes;
  uint32_t m[W];
  match_words<NP, W, G::kStride>(row + grp.sub * (4 * W), code, m);
  const pos_t ms =
      has_ms ? reinterpret_cast<const pos_t*>(row + NP * G::kStride)[col] : 0;
  return ms + grp.sum(count_inclusive<W>(m, static_cast<uint32_t>(pos) & 255u,
                                         grp.sub * W));
}

// BlockRow for a group of GL lanes that share one position: lane sub holds
// words [W sub, W (sub + 1)) of each plane (W = 8 / GL) and, where BlockRow
// asks for them up front, all the milestones; the letter's plane code and
// the count are summed over the group, so every lane returns the LF.
template <class G, int NP, int GL>
struct GroupRow {
  using pos_t = typename G::pos_t;
  using Full = BlockRow<G, NP>;
  static constexpr int W = 8 / GL;
  uint32_t x[NP][W];
  uint4 ms[Full::kMsVec];
  const uint8_t* row;

  __device__ __forceinline__ void load(const AwfmTables& t, pos_t pos, const Group<GL>& grp) {
    row = t.packed + G::block(t.nb, pos) * t.row_bytes;
#pragma unroll
    for (int i = 0; i < NP; ++i) load_words<W>(row + i * G::kStride + grp.sub * (4 * W), x[i]);
    if constexpr (Full::kUpFront) {
#pragma unroll
      for (int q = 0; q < Full::kMsVec; ++q) {
        ms[q] = __ldg(reinterpret_cast<const uint4*>(row + NP * G::kStride) + q);
      }
    }
  }

  // the plane code of the letter at block-local position `local`, from the
  // lane that holds its word
  __device__ __forceinline__ uint32_t code_at(uint32_t local, const Group<GL>& grp) const {
    const uint32_t mine = (local >> 5) - static_cast<uint32_t>(grp.sub * W);
    const uint32_t bit = local & 31u;
    uint32_t code = 0u;
    if (mine < static_cast<uint32_t>(W)) {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        uint32_t word = x[i][0];
#pragma unroll
        for (int j = 1; j < W; ++j) word = mine == static_cast<uint32_t>(j) ? x[i][j] : word;
        code |= ((word >> bit) & 1u) << i;
      }
    }
    return grp.sum(code);
  }

  __device__ __forceinline__ pos_t milestone_of(uint32_t col) const {
    if constexpr (!Full::kUpFront) {
      return reinterpret_cast<const pos_t*>(row + NP * G::kStride)[col];
    } else {
      return select_milestone<pos_t, Full::kMs>(ms, col);
    }
  }

  // LF(pos) from the loaded row, and the letter at pos
  __device__ __forceinline__ pos_t lf(const BlockConsts<pos_t>& s, pos_t pos, uint32_t* letter,
                                      const Group<GL>& grp) const {
    const uint32_t local = static_cast<uint32_t>(pos) & 255u;
    const LetterEntry<pos_t> e = s.by_code[code_at(local, grp)];
    *letter = e.letter();
    if (!e.flag()) return 0;  // sentinel: the same branch in every lane of the group
    const uint32_t cm_code = e.code();
    uint32_t m[W];
#pragma unroll
    for (int w = 0; w < W; ++w) m[w] = 0u;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const uint32_t cm = ((cm_code >> i) & 1u) ? 0xFFFFFFFFu : 0u;
#pragma unroll
      for (int w = 0; w < W; ++w) m[w] |= x[i][w] ^ cm;
    }
#pragma unroll
    for (int w = 0; w < W; ++w) m[w] = ~m[w];
    const uint32_t c = grp.sum(count_inclusive<W>(m, local, grp.sub * W));
    return e.c + milestone_of(e.column()) + c - 1u;
  }
};

// K1, occ mode over a batch (module note): two neighbouring lanes share a
// position (occ_at_group, as K1R), the letter's plane code comes from the
// table in the kernel's parameters, positions and letters are read
// evict-first and the counts stored streaming.
constexpr int kK1OccLanes = 2;

template <class G, int NP>
__global__ void __launch_bounds__(kThreads) k1_occ_kernel(
    AwfmTables t, const int64_t* __restrict__ pos, const int32_t* __restrict__ letters,
    int64_t n, int64_t* __restrict__ out) {
  const Group<kK1OccLanes> grp;
  const int64_t i =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) / kK1OccLanes;
  if (i >= n) return;  // the lanes of a group share i: they leave together
  const uint32_t l = static_cast<uint32_t>(__ldcs(letters + i));
  const bool has_ms = l <= static_cast<uint32_t>(t.card);
  const auto v = occ_at_group<G, NP, kK1OccLanes>(
      t, static_cast<typename G::pos_t>(__ldcs(reinterpret_cast<const long long*>(pos) + i)),
      has_ms ? table_byte(t.letter_code, l) : 0u, has_ms, l, grp);
  if (grp.sub == 0) __stcs(reinterpret_cast<long long*>(out + i), static_cast<long long>(v));
}

// K1's single-query modes (module note): one range or one position passed by
// value, one launch of one warp or less, one 16 B result.
constexpr int kStepGroup = 8;  // lanes that share one row visit

// K1, step mode: the unconditional backward step of one range by letter l
// (<= 255; the launcher clamps), newStart = C[l] + occ(l, start - 1) and
// newEnd = C[l] + occ(l, end) - 1 in pos_t arithmetic. Lanes 0-7 count at
// start - 1 and lanes 8-15 at end, each lane loading one word of every plane
// and the milestone (occ_at_group), so the two row visits and C[l] are asked
// for together; lane 0 takes the end's count by shuffle and writes
// (newStart, newEnd) as one 16 B store.
template <class G, int NP>
__global__ void __launch_bounds__(2 * kStepGroup) k1_step_kernel(
    AwfmTables t, uint64_t start, uint64_t end, uint32_t l, int64_t* __restrict__ out) {
  using pos_t = typename G::pos_t;
  const Group<kStepGroup> grp;
  const LetterEntry<pos_t> e = letter_entry<G>(t, l);
  const pos_t at = threadIdx.x < kStepGroup ? static_cast<pos_t>(start) - 1u
                                            : static_cast<pos_t>(end);
  const pos_t occ = occ_at_group<G, NP, kStepGroup>(t, at, e.code(), e.flag(), e.column(), grp);
  const pos_t occ_e = __shfl_sync((1u << (2 * kStepGroup)) - 1u, occ, kStepGroup);
  if (threadIdx.x == 0) {
    const pos_t new_start = e.c + occ;
    const pos_t new_end = e.c + occ_e - 1u;
    *reinterpret_cast<longlong2*>(out) =
        make_longlong2(static_cast<long long>(new_start), static_cast<long long>(new_end));
  }
}

// K1, LF mode for one position: the letter at pos and LF(pos), the sentinel
// -> 0, through K1R's group step (GroupRow, 8 lanes a row, the planes' words
// and, where BlockRow asks for them up front, the milestones loaded before
// the letter is known); the row's loads are issued before the 32 lanes stage
// C[] in shared memory, so the two overlap. Lane 0 writes (letter, LF) as
// one 16 B store.
template <class G, int NP>
__global__ void __launch_bounds__(32) k1_lf_at_kernel(AwfmTables t, uint64_t pos,
                                                      int64_t* __restrict__ out) {
  using pos_t = typename G::pos_t;
  __shared__ BlockConsts<pos_t> s;
  const Group<kStepGroup> grp;
  const pos_t p = static_cast<pos_t>(pos);
  GroupRow<G, NP, kStepGroup> r;
  r.load(t, p, grp);
  stage_consts<G>(t, s);
  uint32_t lett;
  const pos_t lf = r.lf(s, p, &lett, grp);
  if (threadIdx.x == 0) {
    *reinterpret_cast<longlong2*>(out) =
        make_longlong2(static_cast<long long>(lett), static_cast<long long>(lf));
  }
}

// Nothing: the floor of a single-query call (an empty launch, then the 16 B
// readback), timed by chip_smoke.py and tools.kernel_ab beside K1's modes.
__global__ void empty_kernel() {}

// The shard that owns pos, as the route decides it: its global block, bits
// 8..39 of pos read as int32 (parallel/range_sharded.py: _local_occurrence,
// _local_rows64), lies in [0, n_shards * bps), and the owner is block / bps.
// This is the union of the per-shard tests int32(block - first_block) in
// [0, bps): a block that reads negative, or lies past the padded table,
// belongs to no shard. A narrow position is taken as a u32 value first, so
// its block is below 2^24. Returns the shard, -1 for no shard, and in LF
// mode (ratio > 0) -2 for a lane already at a sample (pos % ratio == 0).
template <class G>
__device__ __forceinline__ int32_t route_of(typename G::pos_t pos, int64_t owned_blocks,
                                            int32_t bps, uint64_t ratio) {
  using pos_t = typename G::pos_t;
  if (ratio != 0u) {
    const pos_t r = static_cast<pos_t>(ratio);
    const bool done = (r & (r - 1u)) == 0u ? (pos & (r - 1u)) == 0u : pos % r == 0u;
    if (done) return -2;
  }
  const int32_t blk = static_cast<int32_t>(static_cast<uint32_t>(pos >> 8));
  return blk >= 0 && blk < owned_blocks ? blk / bps : -1;
}

// One barrier across the grid of a cooperative launch, which guarantees
// that every block is resident; `arrived` is zeroed before the launch.
__device__ __forceinline__ void grid_barrier(uint32_t* arrived) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrived, 1u);
    while (*reinterpret_cast<volatile uint32_t*>(arrived) < gridDim.x) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

// The route: one pass over a step's n positions on the home device. Block b
// takes lanes [b * chunk, (b + 1) * chunk). Phase 1 counts its lanes a shard
// in shared memory and reserves its place in each shard's slice with one
// atomicAdd a shard; after the barrier the slices' starts are the prefix of
// the totals, and phase 2 writes each routed lane's position and lane index
// into its shard's slice (warp-aggregated atomics in shared memory give the
// places, so the order inside a slice varies from run to run; the lane index
// carries each entry home). A lane no shard owns gets `unowned` in out[]
// (occ mode: 0; LF mode: lf_from_letter_occ(0, 0)) and letter 0; in LF mode
// (out is the step's positions, updated in place) every lane not at a sample
// gets off + 1, and a lane at a sample keeps its position and offset.
template <class G>
__global__ void __launch_bounds__(kThreads) k1r_route_kernel(
    const int64_t* pos, int64_t n, int64_t chunk, int32_t n_shards, int32_t bps,
    uint64_t ratio, int64_t unowned, int64_t* out, int64_t* off,
    int32_t* letters_out, int64_t* __restrict__ slot_pos,
    int32_t* __restrict__ slot_lane, uint32_t* counts) {
  using pos_t = typename G::pos_t;
  __shared__ uint32_t cursor[kRouteMaxShards];
  const int64_t owned_blocks = static_cast<int64_t>(n_shards) * bps;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  const int lane = threadIdx.x & 31;
  for (int s = threadIdx.x; s < n_shards; s += blockDim.x) cursor[s] = 0u;
  __syncthreads();
  for (int64_t b = lo; b < hi; b += blockDim.x) {
    const int64_t i = b + threadIdx.x;
    const int32_t s = i < hi ? route_of<G>(static_cast<pos_t>(pos[i]), owned_blocks, bps, ratio)
                             : -3;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, s);
    if (s >= 0 && lane == __ffs(peers) - 1) {
      atomicAdd(&cursor[s], static_cast<uint32_t>(__popc(peers)));
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < n_shards; s += blockDim.x) {
    cursor[s] = atomicAdd(&counts[s], cursor[s]);  // this block's place in the slice
  }
  grid_barrier(&counts[n_shards]);
  for (int s = threadIdx.x; s < n_shards; s += blockDim.x) {
    uint32_t start = 0u;
    for (int u = 0; u < s; ++u) start += *reinterpret_cast<volatile uint32_t*>(&counts[u]);
    cursor[s] += start;
  }
  __syncthreads();
  for (int64_t b = lo; b < hi; b += blockDim.x) {
    const int64_t i = b + threadIdx.x;
    pos_t p = 0;
    int32_t s = -3;
    if (i < hi) {
      p = static_cast<pos_t>(pos[i]);
      s = route_of<G>(p, owned_blocks, bps, ratio);
    }
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, s);
    const int leader = __ffs(peers) - 1;
    uint32_t base = 0u;
    if (s >= 0 && lane == leader) {
      base = atomicAdd(&cursor[s], static_cast<uint32_t>(__popc(peers)));
    }
    base = __shfl_sync(0xFFFFFFFFu, base, leader);
    if (s >= 0) {
      const uint32_t slot = base + __popc(peers & ((1u << lane) - 1u));
      slot_pos[slot] = static_cast<int64_t>(p);
      slot_lane[slot] = static_cast<int32_t>(i);
    } else if (s == -1) {
      out[i] = unowned;
      if (letters_out != nullptr) letters_out[i] = 0;
    }
    if (off != nullptr && s >= -1) off[i] += 1;
  }
}

// [begin, end) of a shard's slice: from the route's totals on the device
// (the prefix of the counts before it), or, for a slice copied to another
// device, [0, count).
__device__ __forceinline__ void slice_of(const uint32_t* counts, int32_t shard,
                                         int64_t count, int64_t* begin, int64_t* end) {
  if (counts == nullptr) {
    *begin = 0;
    *end = count;
    return;
  }
  int64_t start = 0;
  for (int u = 0; u < shard; ++u) start += counts[u];
  *begin = start;
  *end = start + counts[shard];
}

// K1R / K1Rw, occ mode over a shard's slice: occ(letter, pos) of every
// routed lane, stored at its lane (out[lane], the letter letters[lane]). A
// slice copied to another device has no lane indices (slot_lane null): its
// j-th entry takes letters[j] and goes to out[j]. The route has made the
// ownership test, so every position read here lies in the shard: the table's
// row pointer is moved back by first_block rows (launch_k1r), and the row
// code, which indexes rows by the global block, reads the shard's own row. A
// grid sized to the card strides over the slice, two lanes a routed position
// (kK1RGroup).
template <class G, int NP>
__global__ void __launch_bounds__(kThreads) k1r_occ_kernel(
    AwfmTables t, const int64_t* __restrict__ slot_pos,
    const int32_t* __restrict__ slot_lane, const uint32_t* __restrict__ counts,
    int32_t shard, int64_t count, const int32_t* __restrict__ letters,
    int64_t* __restrict__ out) {
  const Group<kK1RGroup> grp;
  int64_t begin, end;
  slice_of(counts, shard, count, &begin, &end);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * (blockDim.x / kK1RGroup);
  for (int64_t j = begin + (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) /
                               kK1RGroup;
       j < end; j += stride) {
    const int64_t at = slot_lane != nullptr ? static_cast<int64_t>(slot_lane[j]) : j;
    const uint32_t l = static_cast<uint32_t>(letters[at]);
    const auto v = occ_at_group<G, NP, kK1RGroup>(
        t, static_cast<typename G::pos_t>(slot_pos[j]), code_of_letter(t, NP, l),
        l <= static_cast<uint32_t>(t.card), l, grp);
    if (grp.sub == 0) out[at] = static_cast<int64_t>(v);
  }
}

// K1R / K1Rw, LF mode over a shard's slice: the owner reads the row once
// (GroupRow, two lanes a routed position) and forms the whole step, the
// letter at pos and LF = C[l] + occ(min(l, ambiguity letter), pos) - 1
// wrapped to the width, the sentinel -> 0, with C[] staged in shared memory
// (BlockConsts), and stores the LF at the lane's position (p_out[lane], in
// place over the step's positions) and the letter at letters_out[lane]
// when asked. Lane indices as in occ mode.
template <class G, int NP>
__global__ void __launch_bounds__(kThreads) k1r_lf_kernel(
    AwfmTables t, const int64_t* __restrict__ slot_pos,
    const int32_t* __restrict__ slot_lane, const uint32_t* __restrict__ counts,
    int32_t shard, int64_t count, int64_t* __restrict__ p_out,
    int32_t* __restrict__ letters_out) {
  using pos_t = typename G::pos_t;
  __shared__ BlockConsts<pos_t> s;
  stage_consts<G>(t, s);
  const Group<kK1RGroup> grp;
  int64_t begin, end;
  slice_of(counts, shard, count, &begin, &end);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * (blockDim.x / kK1RGroup);
  for (int64_t j = begin + (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) /
                               kK1RGroup;
       j < end; j += stride) {
    const pos_t p = static_cast<pos_t>(slot_pos[j]);
    const int64_t at = slot_lane != nullptr ? static_cast<int64_t>(slot_lane[j]) : j;
    GroupRow<G, NP, kK1RGroup> r;
    r.load(t, p, grp);
    uint32_t lett;
    const pos_t lf = r.lf(s, p, &lett, grp);
    if (grp.sub == 0) {
      p_out[at] = static_cast<int64_t>(lf);
      if (letters_out != nullptr) letters_out[at] = static_cast<int32_t>(lett);
    }
  }
}

// K1X / K1WX: one depth of the seed-table BFS (module note). The letter
// count of an alphabet by its plane count: 4 nucleotides over 3 planes,
// 20 amino acids over 5.
template <int NP>
struct Card {
  static constexpr int value = NP == 3 ? 4 : 20;
};

// The plane code of letter l < card, as the two alphabets fix it
// (models/alphabet.py: NT_INDEX_TO_VECTOR, AA_INDEX_TO_VECTOR; the .awfmi
// layout). A constant once the letter loop is unrolled, so that a letter's
// match word is one LOP3 over three planes (two over five);
// launch_k1_extend refuses a table whose codes differ.
template <int NP>
__host__ __device__ constexpr uint32_t letter_code_of(int l) {
  if constexpr (NP == 3) {
    return l == 0 ? 6u : (l == 1 ? 5u : (l == 2 ? 3u : 1u));
  } else {
    switch (l) {
      case 0: return 0x0Cu;  case 1: return 0x17u;  case 2: return 0x03u;
      case 3: return 0x06u;  case 4: return 0x1Eu;  case 5: return 0x1Au;
      case 6: return 0x1Bu;  case 7: return 0x19u;  case 8: return 0x15u;
      case 9: return 0x1Cu;  case 10: return 0x1Du; case 11: return 0x08u;
      case 12: return 0x09u; case 13: return 0x04u; case 14: return 0x13u;
      case 15: return 0x0Au; case 16: return 0x05u; case 17: return 0x16u;
      case 18: return 0x01u; default: return 0x02u;
    }
  }
}

// The milestones of the card letters of one row. A nucleotide row's four
// are loaded up front as one or two 16 B vectors, beside the planes; an
// amino row's twenty (80 B or 160 B) would hold as many registers as its
// planes, so they are loaded one letter at a time, as they are used.
template <class P, int NP>
struct RowMilestones {
  static constexpr bool kUpFront = NP == 3;
  static constexpr int kVec = kUpFront ? Card<NP>::value * static_cast<int>(sizeof(P)) / 16 : 1;
  uint4 v[kVec];
  const P* ms;

  __device__ __forceinline__ void load(const uint8_t* p) {
    ms = reinterpret_cast<const P*>(p);
    if constexpr (kUpFront) {
#pragma unroll
      for (int q = 0; q < kVec; ++q) v[q] = __ldg(reinterpret_cast<const uint4*>(p) + q);
    }
  }

  // the milestone of letter l (a constant once the letter loop is unrolled)
  __device__ __forceinline__ P operator[](int l) const {
    if constexpr (!kUpFront) {
      return ms[l];
    } else if constexpr (sizeof(P) == 4) {
      const uint4 q = v[l / 4];
      return l % 4 == 0 ? q.x : (l % 4 == 1 ? q.y : (l % 4 == 2 ? q.z : q.w));
    } else {
      const uint4 q = v[l / 2];
      return l % 2 == 0 ? (static_cast<uint64_t>(q.y) << 32) | q.x
                        : (static_cast<uint64_t>(q.w) << 32) | q.z;
    }
  }
};

// occ(l, pos) of every letter l < card, inclusive, from pos's block row
// under G's block-index rule (occ_at's counts, exactly): the row's plane
// words and milestones are loaded once, the inclusive masks of pos's local
// position formed once, and each letter costs one match (a LOP3 a word)
// and one masked count.
template <class G, int NP>
__device__ __forceinline__ void counts_at(const AwfmTables& t, typename G::pos_t pos,
                                          typename G::pos_t (&occ)[Card<NP>::value]) {
  using pos_t = typename G::pos_t;
  const uint8_t* row = t.packed + G::block(t.nb, pos) * t.row_bytes;
  uint32_t x[NP][8];
#pragma unroll
  for (int i = 0; i < NP; ++i) load_words<8>(row + i * G::kStride, x[i]);
  RowMilestones<pos_t, NP> ms;
  ms.load(row + NP * G::kStride);
  const uint32_t local = static_cast<uint32_t>(pos) & 255u;
  const uint32_t lw = local >> 5;
  const uint32_t low = (2u << (local & 31u)) - 1u;  // 2u << 31 wraps to 0
  uint32_t mask[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const uint32_t uw = static_cast<uint32_t>(w);
    mask[w] = uw < lw ? 0xFFFFFFFFu : (uw == lw ? low : 0u);
  }
#pragma unroll
  for (int l = 0; l < Card<NP>::value; ++l) {
    const uint32_t code = letter_code_of<NP>(l);
    uint32_t c = 0u;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      uint32_t d = 0u;
#pragma unroll
      for (int i = 0; i < NP; ++i) d |= x[i][w] ^ (((code >> i) & 1u) ? 0xFFFFFFFFu : 0u);
      c += __popc(~d & mask[w]);
    }
    occ[l] = ms[l] + c;
  }
}

// A (start, end) pair of the seed table at index j, read once (evict-first)
// or written once (streaming); with kL2, through the L2 alone
// (ld.global.cg / st.global.cg), for a level that the BFS mode writes and
// reads back inside one launch: another SM wrote it before the grid
// barrier, so its lines must not come from this SM's L1 or the
// non-coherent path.
template <bool kL2 = false, class P>
__device__ __forceinline__ void load_pair(const P* table, int64_t j, P& start, P& end) {
  if constexpr (sizeof(P) == 4) {
    const uint2* p = reinterpret_cast<const uint2*>(table) + j;
    const uint2 v = kL2 ? __ldcg(p) : __ldcs(p);
    start = v.x;
    end = v.y;
  } else {
    const ulonglong2* p = reinterpret_cast<const ulonglong2*>(table) + j;
    const ulonglong2 v = kL2 ? __ldcg(p) : __ldcs(p);
    start = v.x;
    end = v.y;
  }
}

template <bool kL2 = false, class P>
__device__ __forceinline__ void store_pair(P* table, int64_t j, P start, P end) {
  if constexpr (sizeof(P) == 4) {
    uint2* p = reinterpret_cast<uint2*>(table) + j;
    const uint2 v = make_uint2(start, end);
    if constexpr (kL2) {
      __stcg(p, v);
    } else {
      __stcs(p, v);
    }
  } else {
    ulonglong2* p = reinterpret_cast<ulonglong2*>(table) + j;
    const ulonglong2 v = make_ulonglong2(static_cast<unsigned long long>(start),
                                         static_cast<unsigned long long>(end));
    if constexpr (kL2) {
      __stcg(p, v);
    } else {
      __stcs(p, v);
    }
  }
}

constexpr int kExtendParents = 31;  // parents a warp of K1X: lane 31 only counts

// Where a depth's parents come from and where its children go. K1X's
// per-depth entry reads a table handed to it and writes the next (both
// once: evict-first loads, streaming stores).
template <class P>
struct Streamed {
  const P* table;

  __device__ __forceinline__ void load(int64_t i, P& start, P& end) const {
    load_pair(table, i, start, end);
  }
  __device__ __forceinline__ void store(P* nxt, int64_t j, P start, P end) const {
    store_pair(nxt, j, start, end);
  }
};

// The BFS mode reads its first depth from C[] (parent l = [C[l], C[l + 1] -
// 1] in the view's width and wrap: the depth-1 table the host built before)
// and every later one from the level it wrote before the last grid barrier,
// through the L2; it writes the levels it reads back through the L2 and
// the last one streaming.
template <class P>
struct Resident {
  const P* table;  // null: depth 1, from C[]
  const P* c;
  bool last;

  __device__ __forceinline__ void load(int64_t i, P& start, P& end) const {
    if (table == nullptr) {
      start = c[i];
      end = c[i + 1] - 1u;
    } else {
      load_pair<true>(table, i, start, end);
    }
  }
  __device__ __forceinline__ void store(P* nxt, int64_t j, P start, P end) const {
    if (last) {
      store_pair(nxt, j, start, end);
    } else {
      store_pair<true>(nxt, j, start, end);
    }
  }
};

// One warp of K1X: warp `warp` steps kExtendParents consecutive parents of
// the n that `io` reads by every letter, without a validity check (absent
// k-mers keep their stepped-through start > end): child l * n + i = (C[l] +
// occ(l, start_i - 1), C[l] + occ(l, end_i) - 1). A BFS level is in
// lexicographic order, so within a letter's block of it the ranges tile the
// BWT, start_i - 1 == end_{i-1}: lane j counts every letter at one position
// q_j, the start - 1 of the warp's first parent for lane 0 and end_{j-1}
// for the others, takes its end counts from lane j + 1 (q_{j+1} = end_j)
// and its start counts from its own, and counts start - 1 itself only when
// it differs from q_j (a parent that does not follow its neighbour: the
// first of a letter's block, or any table that is no BFS level). So a
// parent costs one row visit and one count per letter, where stepping its
// two ends costs two. Every lane of the warp calls this with the same warp
// and n (the shuffles take all 32).
template <class G, int NP, class IO>
__device__ __forceinline__ void extend_warp(const AwfmTables& t, const IO& io, int64_t n,
                                            int64_t warp, typename G::pos_t* nxt) {
  using pos_t = typename G::pos_t;
  constexpr int kCard = Card<NP>::value;
  constexpr unsigned kAll = 0xFFFFFFFFu;
  const uint32_t lane = threadIdx.x & 31u;
  const int64_t i = warp * kExtendParents + lane;
  const bool live = lane < static_cast<uint32_t>(kExtendParents) && i < n;
  pos_t start = 0, end = 0;
  if (live) io.load(i, start, end);
  const pos_t prev_end = __shfl_up_sync(kAll, end, 1);
  const pos_t q = lane == 0u ? start - 1u : prev_end;
  pos_t occ_q[kCard];
  counts_at<G, NP>(t, q, occ_q);
  pos_t occ_e[kCard];
#pragma unroll
  for (int l = 0; l < kCard; ++l) occ_e[l] = __shfl_down_sync(kAll, occ_q[l], 1);
  if (!live) return;
  if (start - 1u != q) counts_at<G, NP>(t, start - 1u, occ_q);
  const pos_t* c = static_cast<const pos_t*>(t.prefix_sums);
#pragma unroll
  for (int l = 0; l < kCard; ++l) {
    io.store(nxt, l * n + i, c[l] + occ_q[l], c[l] + occ_e[l] - 1u);
  }
}

// K1X / K1WX, one depth a launch: a warp a run of kExtendParents parents.
template <class G, int NP>
__global__ void __launch_bounds__(kThreads)
k1_extend_kernel(AwfmTables t, const typename G::pos_t* __restrict__ table,
                 int64_t n, typename G::pos_t* __restrict__ nxt) {
  const int64_t warp = (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  if (warp * kExtendParents >= n) return;  // the same in every lane of the warp
  extend_warp<G, NP>(t, Streamed<typename G::pos_t>{table}, n, warp, nxt);
}

// The BFS mode (awfm_k1*_seed_table): `steps` depths of the BFS in one
// cooperative launch, from the depth-1 ranges formed from C[] to level
// steps + 1, which goes to `out`. Depth d steps the card^d parents of
// level d into level d + 1 with extend_warp, a warp a run of
// kExtendParents parents; level d + 1 < steps + 1 lies in `levels` (level
// 2 first, each after the one before), and depth d + 1 starts after grid
// barrier d. sync[d - 1] is barrier d's counter (steps - 1 of them) and
// sync[steps - 1 + d - 1] depth d's run counter, which hands a depth's
// runs out eight at a time to a block (a static stride lets a long
// depth's warps drift apart, and the children they store spread over more
// of memory at once); all are zeroed on the stream before the launch.
// steps == 0 writes the depth-1 ranges alone.
template <class G, int NP>
__global__ void __launch_bounds__(kThreads, 2)
k1_seed_table_kernel(AwfmTables t, int steps, typename G::pos_t* levels, uint32_t* sync,
                     typename G::pos_t* out) {
  using pos_t = typename G::pos_t;
  constexpr int kCard = Card<NP>::value;
  __shared__ uint32_t handed;
  const pos_t* c = static_cast<const pos_t*>(t.prefix_sums);
  const int64_t thread = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (steps == 0) {
    for (int64_t i = thread; i < kCard; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
      store_pair(out, i, c[i], static_cast<pos_t>(c[i + 1] - 1u));
    }
    return;
  }
  uint32_t* taken = sync + (steps - 1);
  Resident<pos_t> io{nullptr, c, false};
  pos_t* next = levels;
  int64_t n = kCard;
  for (int d = 1; d <= steps; ++d) {
    io.last = d == steps;
    pos_t* children = io.last ? out : next;
    const int64_t runs = (n + kExtendParents - 1) / kExtendParents;
    for (;;) {
      if (threadIdx.x == 0) handed = atomicAdd(&taken[d - 1], blockDim.x >> 5);
      __syncthreads();
      const int64_t w = static_cast<int64_t>(handed) + (threadIdx.x >> 5);
      const bool done = handed >= runs;
      __syncthreads();
      if (done) break;
      if (w < runs) extend_warp<G, NP>(t, io, n, w, children);
    }
    if (io.last) break;
    grid_barrier(&sync[d - 1]);
    io.table = children;
    next = children + 2 * n * kCard;
    n *= kCard;
  }
}

constexpr int kK2Group = 2;  // lanes per query in K2 and K2w

// GL neighbouring lanes walk one query right to left; LW as in QueryRow;
// PAIR as in backward_step; COUNT: the steps by class into row_steps
// (RowSteps).
template <class G, int NP, int GL, int LW, bool PAIR, bool COUNT>
__global__ void __launch_bounds__(kThreads)
k2_ranges_kernel(AwfmTables t,
                 const typename G::pos_t* __restrict__ seed_table,
                 int64_t seed_rows, int k,
                 const uint8_t* __restrict__ mat, int64_t b, int64_t l_pad,
                 const int32_t* __restrict__ lengths,
                 const uint8_t* __restrict__ seeded,
                 int64_t* __restrict__ start_out,
                 int64_t* __restrict__ end_out,
                 unsigned long long* __restrict__ row_steps) {
  using pos_t = typename G::pos_t;
  const int64_t q =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) / GL;
  const bool live = q < b;
  const int64_t qq = live ? q : 0;
  const QueryRow<LW> row(mat + qq * l_pad, l_pad);
  const int64_t len = lengths[qq];
  const bool from_seed = seeded[qq] != 0;
  const uint32_t card = static_cast<uint32_t>(t.card);
  pos_t start = 1, end = 0;
  if (from_seed) {
    seed_range(seed_table, seed_rows, k, card, row, len, l_pad, start, end);
  }
  if (!live) return;
  int64_t next = len - k - 1;
  if (!from_seed) {
    const int64_t c = len - 1 < 0 ? 0 : len - 1;
    const uint32_t last = row[c];
    const uint32_t a = last < card + 1u ? last : card + 1u;
    const uint32_t z = last + 1u < card + 1u ? last + 1u : card + 1u;
    const pos_t* ps = static_cast<const pos_t*>(t.prefix_sums);
    start = ps[a];
    end = ps[z] - 1u;
    next = len - 2;
  }
  const Group<GL> grp;
  RowSteps steps;
  for (int64_t p = next; p >= 0 && start <= end; --p) {
    const bool first =
        backward_step<G, NP, GL, PAIR>(t, letter_entry<G>(t, row[p]), start, end, grp);
    if constexpr (COUNT) steps.add(first, grp.sub);
  }
  if (grp.sub == 0) store_range(start_out, end_out, q, start, end);
  if constexpr (COUNT) steps.flush(row_steps);
}

constexpr int kK3Threads = 256;

// LF(pos) in three dependent reads: the letter from one byte load per
// plane, then the row's words and the one milestone of that letter (the
// tables of the kernel's parameters give letter and code). K3w keeps it:
// on wide rows, where the walk is bound by the 64 B pieces device memory
// moves and not by round trips, the block row in registers measured level
// on random hits and 5% behind on hits in range order; two lanes a hit,
// each loading half of every plane's first-block sector (the letter from
// their words by shuffle, one lane loading the milestone), 14% behind on
// the 64M index forced wide and 1-2% behind beyond the L2 and on amino
// rows; a prefetch of the milestone piece into the L2 before the byte
// loads, 4-8% ahead on a 268 MB table but 2-3% behind on a 4.56 GB one
// (H100 80GB HBM3, 700 W, each against this form in one process).
template <class G, int NP>
__device__ __forceinline__ typename G::pos_t lf_bytes(const AwfmTables& t,
                                                      typename G::pos_t pos) {
  using pos_t = typename G::pos_t;
  const uint8_t* row = t.packed + G::block(t.nb, pos) * t.row_bytes;
  const uint32_t local = static_cast<uint32_t>(pos) & 255u;
  uint32_t code = 0u;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    code |= ((row[i * G::kStride + (local >> 3)] >> (local & 7u)) & 1u) << i;
  }
  const uint32_t card = static_cast<uint32_t>(t.card);
  const uint32_t lett = table_byte(t.code_letter, code);
  if (lett == card + 1u) return 0;  // sentinel
  const uint32_t lc = lett < card ? lett : card;
  uint32_t m[8];
  match_words<NP, 8, G::kStride>(row, table_byte(t.letter_code, lc), m);
  return static_cast<const pos_t*>(t.prefix_sums)[lc] +
         reinterpret_cast<const pos_t*>(row + NP * G::kStride)[lc] +
         count_inclusive<8>(m, local) - 1u;
}

// K3w: one thread walks one hit, in launch order. A warp ends with its
// longest walk, which on wide rows costs nothing the card could use: the
// grid that hands out hits (below) measured 4% behind this on random hits
// and 16% behind in the on-disk form, and two lanes a hit (lf_bytes) 1-14%
// behind. G is Wide, or WideCompact (a wide view without pair rows), where
// the grid measured behind too (the module note). shift: log2(ratio), or -1
// when ratio is no power of two (p % ratio in u64 is a software routine).
template <class G, int NP>
__global__ void __launch_bounds__(kK3Threads)
k3_per_hit_kernel(AwfmTables t, const int64_t* __restrict__ pos, int64_t n,
                  typename G::pos_t ratio, int shift, typename G::pos_t bwt_length,
                  const typename G::pos_t* __restrict__ sa,
                  int64_t* __restrict__ hits_out, int64_t* __restrict__ p_out,
                  int64_t* __restrict__ off_out) {
  using pos_t = typename G::pos_t;
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  pos_t p = static_cast<pos_t>(pos[i]);
  pos_t off = 0;
  // a valid BWT's LF walk reaches a sampled position in < bwtLength steps;
  // the bound only keeps a malformed index from spinning forever
  while ((shift >= 0 ? (p & (ratio - 1u)) != 0 : p % ratio != 0) && off < bwt_length) {
    p = lf_bytes<G, NP>(t, p);
    ++off;
  }
  if (sa != nullptr) {
    // sa < bwtLength and off <= bwtLength < 2^39: the sum cannot wrap
    const uint64_t h = static_cast<uint64_t>(sa[shift >= 0 ? p >> shift : p / ratio]) + off;
    hits_out[i] = static_cast<int64_t>(h % bwt_length);
  } else {
    p_out[i] = static_cast<int64_t>(p);
    off_out[i] = static_cast<int64_t>(off);
  }
}

// K3 (narrow rows): block b walks hits [b * chunk, (b + 1) * chunk) on a
// grid the card holds at once. A lane whose walk has ended writes its
// result at the hit's own index and takes the block's next hit, so the
// lanes of a warp stay busy whatever the walks' lengths. One turn of the
// loop is one round trip: the walking lanes' rows, the ending lanes' SA
// entries and the next hits' positions (both read once, so loaded
// evict-first) are asked for together and used after. The results are
// stored plainly: the 8 B of neighbouring hits arrive at different times
// and meet in the L2. shift: log2(ratio), or -1 when ratio is no power of
// two.
template <class G, int NP>
__global__ void __launch_bounds__(kK3Threads)
k3_backtrace_resolve_kernel(
    AwfmTables t, const int64_t* __restrict__ pos, int64_t n, int64_t chunk,
    typename G::pos_t ratio, int shift, typename G::pos_t bwt_length,
    const typename G::pos_t* __restrict__ sa, int64_t* __restrict__ hits_out,
    int64_t* __restrict__ p_out, int64_t* __restrict__ off_out) {
  using pos_t = typename G::pos_t;
  constexpr unsigned kAll = 0xFFFFFFFFu;
  __shared__ BlockConsts<pos_t> s;
  __shared__ unsigned long long taken;  // hits of the chunk handed out
  const int64_t lo = blockIdx.x * chunk;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  if (threadIdx.x == 0) taken = 0ull;
  stage_consts<G>(t, s);
  const unsigned lane = threadIdx.x & 31u;
  int64_t i = -1;  // the hit this lane walks; -1: none
  pos_t p = 0, off = 0;
  bool exhausted = false;  // the chunk has no hit left (the same in a warp)
  for (;;) {
    // off < bwt_length: as in k3_per_hit_kernel
    const bool sampled = shift >= 0 ? (p & (ratio - 1u)) == 0 : p % ratio == 0;
    const bool walking = i >= 0 && !sampled && off < bwt_length;
    const bool ending = i >= 0 && !walking;
    BlockRow<G, NP> r;
    if (walking) r.load(t, p);
    pos_t sav = 0;
    if (ending && sa != nullptr) {
      const pos_t* entry = sa + (shift >= 0 ? p >> shift : p / ratio);
      sav = __ldcs(entry);
    }
    int64_t j = -1;
    pos_t pj = 0;
    if (!exhausted) {
      const unsigned want = __ballot_sync(kAll, !walking);
      if (want != 0u) {
        unsigned long long base = 0ull;
        if (lane == 0u) base = atomicAdd(&taken, static_cast<unsigned long long>(__popc(want)));
        base = __shfl_sync(kAll, base, 0);
        if (!walking) {
          const int64_t mine = lo + static_cast<int64_t>(base) + __popc(want & ((1u << lane) - 1u));
          if (mine < hi) {
            j = mine;
            pj = static_cast<pos_t>(__ldcs(pos + mine));
          }
        }
        exhausted = lo + static_cast<int64_t>(base) + __popc(want) >= hi;
      }
    }
    if (walking) {
      uint32_t lett;
      p = r.lf(s, p, &lett);
      ++off;
    } else {
      if (ending) {
        if (sa != nullptr) {
          // sa < bwtLength and off <= bwtLength < 2^39: the sum cannot wrap
          const uint64_t h = static_cast<uint64_t>(sav) + off;
          hits_out[i] = static_cast<int64_t>(h % bwt_length);
        } else {
          p_out[i] = static_cast<int64_t>(p);
          off_out[i] = static_cast<int64_t>(off);
        }
      }
      i = j;
      p = pj;
      off = 0;
    }
    if (__all_sync(kAll, i < 0)) break;
  }
}

constexpr int kK4Group = 2;  // lanes per query

// Every query has length kmer_len > k and letters < 4 (the n-gram fast
// path's contract, checked by the host engine). kK4Group lanes walk one
// query, its letters in registers where LW > 0 (QueryRow); the seed-table
// entry is loaded and the ranges are stored with the streaming hints
// (.cs). PAIR: the tail steps over the pair rows, else over the block rows
// (backward_step); the n-gram steps read the n-gram pair rows either way,
// as the JAX package's do. COUNT: the tail steps by class into row_steps
// (RowSteps).
template <int N, int NP, int LW, bool PAIR, bool COUNT>
__global__ void __launch_bounds__(kThreads, 2)
k4_ngram_ranges_kernel(AwfmTables t, NgramTables g,
                       const uint32_t* __restrict__ seed_table,
                       int64_t seed_rows, int k,
                       const uint8_t* __restrict__ mat, int64_t b,
                       int64_t l_pad, int kmer_len,
                       int64_t* __restrict__ start_out,
                       int64_t* __restrict__ end_out,
                       unsigned long long* __restrict__ row_steps) {
  constexpr int GL = kK4Group;
  const int64_t q =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) / GL;
  if (q >= b) return;
  const QueryRow<LW> row(mat + q * l_pad, l_pad);
  const Group<GL> grp;
  uint32_t start, end;
  seed_range(seed_table, seed_rows, k, static_cast<uint32_t>(t.card), row,
             kmer_len, l_pad, start, end);
  const int m = kmer_len - k;
  // step s prepends columns m - N(s+1) .. m - N s - 1, leftmost first
  for (int st = 0; st < m / N && start <= end; ++st) {
    uint32_t v = 0u;
#pragma unroll
    for (int j = 0; j < N; ++j) v = v * 4u + row[m - N * (st + 1) + j];
    ngram_step<N, GL>(g, start, end, v, grp);
  }
  RowSteps steps;
  for (int p = m % N - 1; p >= 0 && start <= end; --p) {
    const bool first = backward_step<Narrow, NP, GL, PAIR>(
        t, letter_entry<Narrow>(t, row[p]), start, end, grp);
    if constexpr (COUNT) steps.add(first, grp.sub);
  }
  if (grp.sub == 0) store_range(start_out, end_out, q, start, end);
  if constexpr (COUNT) steps.flush(row_steps);
}

unsigned int grid_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

// The row bytes of a layout: n_planes planes `stride` bytes apart, then
// card + 1 milestones of G's position type, padded to 128 B
// (models/index.py:device_row_bytes, device_pair_row_bytes,
// device_row_bytes64).
template <class G>
int padded_row_bytes(const AwfmTables* t, int stride) {
  const int need = t->n_planes * stride +
                   (t->card + 1) * static_cast<int>(sizeof(typename G::pos_t));
  return (need + 127) / 128 * 128;
}

// Whether the tables are in the layout a form reads: G's rows (planes
// G::kStride apart) and, for a form that steps over pair rows (PAIR), pair
// rows with planes 64 B apart, or for one that does not, no pair table.
// Every launcher refuses other tables before it launches; ops/kernels.py
// checks the view's layout first (_tables). Nucleotide wide rows are
// 256 B in both wide layouts, so there the view's pair_fused flag, checked
// in _tables, is what tells them apart.
template <class G>
bool rows_fit(const AwfmTables* t) {
  return t->row_bytes == padded_row_bytes<G>(t, G::kStride);
}

template <class G, bool PAIR>
bool pair_rows_fit(const AwfmTables* t) {
  if (PAIR != (t->packed_pair != nullptr)) return false;
  return !PAIR || t->pair_row_bytes == padded_row_bytes<G>(t, 64);
}

// The launchers behind the C entry points: one per kernel, the width a
// template argument, the plane count (3 nucleotide, 5 amino) chosen here.
template <class G>
int launch_k1_occ(int device, const AwfmTables* t, const int64_t* pos,
                  const int32_t* letters, int64_t n, int64_t* out,
                  cudaStream_t stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!rows_fit<G>(t)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int grid = grid_for(n * kK1OccLanes);
  if (t->n_planes == 3) {
    k1_occ_kernel<G, 3><<<grid, kThreads, 0, stream>>>(*t, pos, letters, n, out);
  } else if (t->n_planes == 5) {
    k1_occ_kernel<G, 5><<<grid, kThreads, 0, stream>>>(*t, pos, letters, n, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1's step mode: the range and the letter by value. Every letter above 255
// is above the sentinel index, as 255 is: C = 0, code 0, no milestone.
template <class G>
int launch_k1_step(int device, const AwfmTables* t, uint64_t start, uint64_t end,
                   uint32_t letter, int64_t* out, cudaStream_t stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!rows_fit<G>(t)) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t l = letter < 255u ? letter : 255u;
  if (t->n_planes == 3) {
    k1_step_kernel<G, 3><<<1, 2 * kStepGroup, 0, stream>>>(*t, start, end, l, out);
  } else if (t->n_planes == 5) {
    k1_step_kernel<G, 5><<<1, 2 * kStepGroup, 0, stream>>>(*t, start, end, l, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1's LF mode for one position, by value.
template <class G>
int launch_k1_lf_at(int device, const AwfmTables* t, uint64_t pos, int64_t* out,
                    cudaStream_t stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!rows_fit<G>(t)) return static_cast<int>(cudaErrorInvalidValue);
  if (t->n_planes == 3) {
    k1_lf_at_kernel<G, 3><<<1, 32, 0, stream>>>(*t, pos, out);
  } else if (t->n_planes == 5) {
    k1_lf_at_kernel<G, 5><<<1, 32, 0, stream>>>(*t, pos, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class G>
int launch_k1_letter_lf(int device, const AwfmTables* t, const int64_t* pos,
                        int64_t n, int32_t* letters_out, int64_t* lf_out,
                        cudaStream_t stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!rows_fit<G>(t)) return static_cast<int>(cudaErrorInvalidValue);
  if (t->n_planes == 3) {
    k1_letter_lf_kernel<G, 3><<<grid_for(n), kThreads, 0, stream>>>(
        *t, pos, n, letters_out, lf_out);
  } else if (t->n_planes == 5) {
    k1_letter_lf_kernel<G, 5><<<grid_for(n), kThreads, 0, stream>>>(
        *t, pos, n, letters_out, lf_out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1R's tables: the shard's rows stand at packed, global block b at row
// b - first_block, so the row pointer is moved back by first_block rows
// (the arithmetic is modulo 2^64, and only owned blocks are read) and the
// table is taken to end at first_block + the shard's rows.
int k1r_tables(int device, const AwfmTables* t, int32_t first_block,
               AwfmTables* shifted) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (first_block < 0 || t->nb < 1 || first_block + t->nb > INT32_MAX ||
      (t->n_planes != 3 && t->n_planes != 5)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *shifted = *t;
  shifted->packed = reinterpret_cast<const uint8_t*>(
      reinterpret_cast<uintptr_t>(t->packed) -
      static_cast<uintptr_t>(first_block) * static_cast<uintptr_t>(t->row_bytes));
  shifted->packed_pair = shifted->packed;
  shifted->nb = first_block + t->nb;
  return 0;
}

// Blocks of kThreads that the card holds at once for `kernel`, at most
// enough for n items (at least 1). The occupancy and the SM count are
// looked up once a kernel and a device.
template <auto kernel>
int resident_grid(int device, int64_t n, unsigned int* grid) {
  static int per_sm = 0;
  static int sms[64] = {0};
  cudaError_t err = cudaSuccess;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int count = device >= 0 && device < 64 ? sms[device] : 0;
  if (count == 0) {
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= 0 && device < 64) sms[device] = count;
  }
  int64_t blocks = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * count;
  const int64_t fit = (n + kThreads - 1) / kThreads;
  if (blocks > fit) blocks = fit;
  *grid = static_cast<unsigned int>(blocks > 0 ? blocks : 1);
  return 0;
}

// The route: the counts (n_shards totals and the barrier's counter) are
// zeroed on the stream, then one cooperative launch on a grid the card holds
// at once, each block a contiguous chunk of the lanes.
template <class G>
int launch_k1r_route(int device, const int64_t* pos, int64_t n, int32_t n_shards,
                     int32_t bps, uint64_t ratio, int64_t unowned, int64_t* out,
                     int64_t* off, int32_t* letters_out, int64_t* slot_pos,
                     int32_t* slot_lane, uint32_t* counts, cudaStream_t stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0 || n > INT32_MAX || n_shards < 1 || n_shards > kRouteMaxShards || bps < 1 ||
      static_cast<int64_t>(n_shards) * bps > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaMemsetAsync(counts, 0, (n_shards + 1) * sizeof(uint32_t), stream);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  unsigned int grid = 0;
  const int rc = resident_grid<k1r_route_kernel<G>>(device, n, &grid);
  if (rc != 0) return rc;
  int64_t chunk = (n + grid - 1) / grid;
  void* args[] = {&pos, &n, &chunk, &n_shards, &bps, &ratio, &unowned, &out,
                  &off, &letters_out, &slot_pos, &slot_lane, &counts};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(k1r_route_kernel<G>),
                                    dim3(grid), dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// A shard's launch over its slice, on a grid the card holds at once, at
// most enough for `capacity` lanes (the route's batch, which bounds a slice).
template <class G, int NP>
int launch_k1r_occ_planes(int device, const AwfmTables& s, const int64_t* slot_pos,
                          const int32_t* slot_lane, const uint32_t* counts, int32_t shard,
                          int64_t count, int64_t capacity, const int32_t* letters,
                          int64_t* out, cudaStream_t stream) {
  unsigned int grid = 0;
  const int rc = resident_grid<k1r_occ_kernel<G, NP>>(device, capacity * kK1RGroup, &grid);
  if (rc != 0) return rc;
  k1r_occ_kernel<G, NP><<<grid, kThreads, 0, stream>>>(s, slot_pos, slot_lane, counts, shard,
                                                       count, letters, out);
  return static_cast<int>(cudaGetLastError());
}

template <class G, int NP>
int launch_k1r_lf_planes(int device, const AwfmTables& s, const int64_t* slot_pos,
                         const int32_t* slot_lane, const uint32_t* counts, int32_t shard,
                         int64_t count, int64_t capacity, int64_t* p_out,
                         int32_t* letters_out, cudaStream_t stream) {
  unsigned int grid = 0;
  const int rc = resident_grid<k1r_lf_kernel<G, NP>>(device, capacity * kK1RGroup, &grid);
  if (rc != 0) return rc;
  k1r_lf_kernel<G, NP><<<grid, kThreads, 0, stream>>>(s, slot_pos, slot_lane, counts, shard,
                                                      count, p_out, letters_out);
  return static_cast<int>(cudaGetLastError());
}

template <class G>
int launch_k1r_occ(int device, const AwfmTables* t, int32_t first_block,
                   const int64_t* slot_pos, const int32_t* slot_lane,
                   const uint32_t* counts, int32_t shard, int64_t count,
                   int64_t capacity, const int32_t* letters, int64_t* out,
                   cudaStream_t stream) {
  if (!rows_fit<G>(t)) return static_cast<int>(cudaErrorInvalidValue);
  AwfmTables s;
  const int rc = k1r_tables(device, t, first_block, &s);
  if (rc != 0) return rc;
  if (capacity <= 0) return 0;
  if (t->n_planes == 3) {
    return launch_k1r_occ_planes<G, 3>(device, s, slot_pos, slot_lane, counts, shard, count,
                                       capacity, letters, out, stream);
  }
  return launch_k1r_occ_planes<G, 5>(device, s, slot_pos, slot_lane, counts, shard, count,
                                     capacity, letters, out, stream);
}

template <class G>
int launch_k1r_lf(int device, const AwfmTables* t, int32_t first_block,
                  const int64_t* slot_pos, const int32_t* slot_lane,
                  const uint32_t* counts, int32_t shard, int64_t count,
                  int64_t capacity, int64_t* p_out, int32_t* letters_out,
                  cudaStream_t stream) {
  if (!rows_fit<G>(t)) return static_cast<int>(cudaErrorInvalidValue);
  AwfmTables s;
  const int rc = k1r_tables(device, t, first_block, &s);
  if (rc != 0) return rc;
  if (capacity <= 0) return 0;
  if (t->n_planes == 3) {
    return launch_k1r_lf_planes<G, 3>(device, s, slot_pos, slot_lane, counts, shard, count,
                                      capacity, p_out, letters_out, stream);
  }
  return launch_k1r_lf_planes<G, 5>(device, s, slot_pos, slot_lane, counts, shard, count,
                                    capacity, p_out, letters_out, stream);
}

// Whether the table's letter codes are the ones K1X is compiled for.
template <int NP>
bool letter_codes_match(const AwfmTables* t) {
  for (int l = 0; l < Card<NP>::value; ++l) {
    const uint32_t byte = static_cast<uint32_t>(t->letter_code[l / 8] >> (8 * (l % 8))) & 255u;
    if (byte != letter_code_of<NP>(l)) return false;
  }
  return true;
}

template <class G>
int launch_k1_extend(int device, const AwfmTables* t,
                     const typename G::pos_t* table, int64_t n,
                     typename G::pos_t* nxt, cudaStream_t stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!rows_fit<G>(t)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int grid = grid_for((n + kExtendParents - 1) / kExtendParents * 32);
  if (t->n_planes == 3 && t->card == Card<3>::value && letter_codes_match<3>(t)) {
    k1_extend_kernel<G, 3><<<grid, kThreads, 0, stream>>>(*t, table, n, nxt);
  } else if (t->n_planes == 5 && t->card == Card<5>::value && letter_codes_match<5>(t)) {
    k1_extend_kernel<G, 5><<<grid, kThreads, 0, stream>>>(*t, table, n, nxt);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The BFS mode's 4 B counters for a table of `levels` levels: a barrier's
// between two of its levels - 1 depths, and a depth's runs handed out.
int64_t seed_table_counters(int levels) { return levels >= 2 ? 2 * levels - 3 : 0; }

// Bytes of the BFS mode's scratch for a table of `levels` levels: the
// counters, rounded up to 16 B, then levels 2 .. levels - 1, each card^j
// (start, end) pairs of pos_bytes each; level `levels` goes to the
// output. ops/kernels.py:k1_seed_table sizes the scratch with it
// (awfm_seed_table_scratch_bytes).
int64_t seed_table_scratch_bytes(int64_t card, int levels, int64_t pos_bytes) {
  int64_t bytes = (seed_table_counters(levels) * 4 + 15) / 16 * 16;
  int64_t n = card;
  for (int j = 2; j < levels; ++j) {
    n *= card;
    bytes += n * 2 * pos_bytes;
  }
  return bytes;
}

template <class G, int NP>
int launch_k1_seed_table_planes(int device, const AwfmTables* t, int levels, uint8_t* scratch,
                                typename G::pos_t* out, cudaStream_t stream) {
  using pos_t = typename G::pos_t;
  constexpr int64_t kCard = Card<NP>::value;
  int steps = levels - 1;
  const int64_t counters = seed_table_counters(levels);
  uint32_t* sync = reinterpret_cast<uint32_t*>(scratch);
  pos_t* level2 = reinterpret_cast<pos_t*>(scratch + (counters * 4 + 15) / 16 * 16);
  if (counters > 0) {
    const cudaError_t err = cudaMemsetAsync(sync, 0, counters * sizeof(uint32_t), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // enough blocks for the deepest depth's runs of parents, at most what the
  // card holds at once
  int64_t n = kCard;
  for (int d = 1; d < steps; ++d) n *= kCard;
  const int64_t threads = steps == 0 ? kCard : (n + kExtendParents - 1) / kExtendParents * 32;
  unsigned int grid = 0;
  const int rc = resident_grid<k1_seed_table_kernel<G, NP>>(device, threads, &grid);
  if (rc != 0) return rc;
  AwfmTables tables = *t;
  void* args[] = {&tables, &steps, &level2, &sync, &out};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(k1_seed_table_kernel<G, NP>), dim3(grid), dim3(kThreads),
      args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The BFS mode: a table of card^levels ranges (levels >= 1) in one
// cooperative launch on a grid the card holds at once. `scratch` holds
// seed_table_scratch_bytes(card, levels, sizeof(pos_t)) bytes (null when
// that is 0); the counters in it are zeroed on the stream first, as the
// route zeroes its own. A refused launch (a grid the card cannot hold,
// say) returns its error: nothing falls back.
template <class G>
int launch_k1_seed_table(int device, const AwfmTables* t, int levels, uint8_t* scratch,
                         int64_t scratch_bytes, typename G::pos_t* out, cudaStream_t stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!rows_fit<G>(t) || levels < 1) return static_cast<int>(cudaErrorInvalidValue);
  int64_t total = 1;
  for (int j = 0; j < levels && total < INT32_MAX; ++j) total *= t->card;
  if (total >= INT32_MAX || reinterpret_cast<uintptr_t>(scratch) % 16 ||
      scratch_bytes < seed_table_scratch_bytes(t->card, levels, sizeof(typename G::pos_t))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (t->n_planes == 3 && t->card == Card<3>::value && letter_codes_match<3>(t)) {
    return launch_k1_seed_table_planes<G, 3>(device, t, levels, scratch, out, stream);
  }
  if (t->n_planes == 5 && t->card == Card<5>::value && letter_codes_match<5>(t)) {
    return launch_k1_seed_table_planes<G, 5>(device, t, levels, scratch, out, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class G, int NP, int LW, bool PAIR, bool COUNT>
void launch_k2_form(const AwfmTables* t, const typename G::pos_t* seed_table,
                    int64_t seed_rows, int k, const uint8_t* mat, int64_t b,
                    int64_t l_pad, const int32_t* lengths,
                    const uint8_t* seeded, int64_t* start_out,
                    int64_t* end_out, unsigned long long* row_steps,
                    cudaStream_t stream) {
  k2_ranges_kernel<G, NP, kK2Group, LW, PAIR, COUNT>
      <<<grid_for(b * kK2Group), kThreads, 0, stream>>>(
          *t, seed_table, seed_rows, k, mat, b, l_pad, lengths, seeded,
          start_out, end_out, row_steps);
}

template <class G, int NP, bool PAIR, bool COUNT>
void launch_k2_planes(const AwfmTables* t, const typename G::pos_t* seed_table,
                      int64_t seed_rows, int k, const uint8_t* mat, int64_t b,
                      int64_t l_pad, const int32_t* lengths,
                      const uint8_t* seeded, int64_t* start_out,
                      int64_t* end_out, unsigned long long* row_steps,
                      cudaStream_t stream) {
  // letters in registers where the rows are whole aligned words of at most
  // 32 letters (the bench protocol's 25-mers); longer ones are not measured
  if (l_pad % 4 == 0 && l_pad <= 32 && reinterpret_cast<uintptr_t>(mat) % 4 == 0) {
    launch_k2_form<G, NP, 8, PAIR, COUNT>(t, seed_table, seed_rows, k, mat, b, l_pad,
                                          lengths, seeded, start_out, end_out, row_steps,
                                          stream);
  } else {
    launch_k2_form<G, NP, 0, PAIR, COUNT>(t, seed_table, seed_rows, k, mat, b, l_pad,
                                          lengths, seeded, start_out, end_out, row_steps,
                                          stream);
  }
}

// PAIR: the form over pair rows, which needs the pair table; else the form
// over the block rows, which needs none. COUNT: the counting instantiation
// (RowSteps into row_steps), which a narrow form and K2w over pair-fused
// rows launch when handed a counter.
template <class G, bool PAIR, bool COUNT = false>
int launch_k2_ranges(int device, const AwfmTables* t,
                     const typename G::pos_t* seed_table, int64_t seed_rows,
                     int k, const uint8_t* mat, int64_t b, int64_t l_pad,
                     const int32_t* lengths, const uint8_t* seeded,
                     int64_t* start_out, int64_t* end_out,
                     cudaStream_t stream, unsigned long long* row_steps = nullptr) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!rows_fit<G>(t) || !pair_rows_fit<G, PAIR>(t)) return static_cast<int>(cudaErrorInvalidValue);
  if (t->n_planes == 3) {
    launch_k2_planes<G, 3, PAIR, COUNT>(t, seed_table, seed_rows, k, mat, b, l_pad, lengths,
                                        seeded, start_out, end_out, row_steps, stream);
  } else if (t->n_planes == 5) {
    launch_k2_planes<G, 5, PAIR, COUNT>(t, seed_table, seed_rows, k, mat, b, l_pad, lengths,
                                        seeded, start_out, end_out, row_steps, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class G, int NP>
int launch_k3_planes(int device, const AwfmTables* t, const int64_t* pos,
                     int64_t n, typename G::pos_t ratio,
                     typename G::pos_t bwt_length,
                     const typename G::pos_t* sa, int64_t* hits_out,
                     int64_t* p_out, int64_t* off_out, cudaStream_t stream) {
  int shift = -1;
  if ((ratio & (ratio - 1u)) == 0) {
    for (shift = 0; (static_cast<typename G::pos_t>(1) << shift) != ratio; ++shift) {}
  }
  if constexpr (sizeof(typename G::pos_t) == 8) {
    k3_per_hit_kernel<G, NP><<<grid_for(n), kK3Threads, 0, stream>>>(
        *t, pos, n, ratio, shift, bwt_length, sa, hits_out, p_out, off_out);
  } else {
    // a grid the card holds at once, each block with an equal share of the hits
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, k3_backtrace_resolve_kernel<G, NP>, kK3Threads, 0);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    int64_t blocks = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
    const int64_t fit = (n + kK3Threads - 1) / kK3Threads;
    if (blocks > fit) blocks = fit;
    const int64_t chunk = (n + blocks - 1) / blocks;
    k3_backtrace_resolve_kernel<G, NP>
        <<<static_cast<unsigned int>(blocks), kK3Threads, 0, stream>>>(
            *t, pos, n, chunk, ratio, shift, bwt_length, sa, hits_out, p_out,
            off_out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class G>
int launch_k3_backtrace_resolve(int device, const AwfmTables* t,
                                const int64_t* pos, int64_t n,
                                typename G::pos_t ratio,
                                typename G::pos_t bwt_length,
                                const typename G::pos_t* sa, int64_t* hits_out,
                                int64_t* p_out, int64_t* off_out,
                                cudaStream_t stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!rows_fit<G>(t)) return static_cast<int>(cudaErrorInvalidValue);
  if (ratio == 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (t->n_planes == 3) {
    return launch_k3_planes<G, 3>(device, t, pos, n, ratio, bwt_length, sa,
                                  hits_out, p_out, off_out, stream);
  }
  if (t->n_planes == 5) {
    return launch_k3_planes<G, 5>(device, t, pos, n, ratio, bwt_length, sa,
                                  hits_out, p_out, off_out, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int N, bool PAIR, bool COUNT>
void launch_k4_letters(const AwfmTables* t, const NgramTables* g, const uint32_t* seed_table,
                       int64_t seed_rows, int k, const uint8_t* mat, int64_t b, int64_t l_pad,
                       int kmer_len, int64_t* start_out, int64_t* end_out,
                       unsigned long long* row_steps, cudaStream_t stream) {
  const unsigned int grid = grid_for(b * kK4Group);
  // letters in registers where the rows are whole aligned words of at most
  // 32 letters, as K2 takes them (launch_k2_planes)
  if (l_pad % 4 == 0 && l_pad <= 32 && reinterpret_cast<uintptr_t>(mat) % 4 == 0) {
    k4_ngram_ranges_kernel<N, 3, 8, PAIR, COUNT><<<grid, kThreads, 0, stream>>>(
        *t, *g, seed_table, seed_rows, k, mat, b, l_pad, kmer_len, start_out, end_out,
        row_steps);
  } else {
    k4_ngram_ranges_kernel<N, 3, 0, PAIR, COUNT><<<grid, kThreads, 0, stream>>>(
        *t, *g, seed_table, seed_rows, k, mat, b, l_pad, kmer_len, start_out, end_out,
        row_steps);
  }
}

// Whether an n-gram table is in K4's layout (NgramRow): its width for n
// and 16 B aligned rows. The bytes' order the width cannot show; the
// table K4 is handed is NgramIndex.k4, which ops/ngram.py:k4_rows makes
// and nothing else writes, and ops/kernels.py refuses an index without it.
bool ngram_rows_fit(const NgramTables* g) {
  const int want = g->n == 2 ? NgramRow<2>::kBytes : (g->n == 3 ? NgramRow<3>::kBytes : 0);
  return want != 0 && g->row_bytes == want &&
         reinterpret_cast<uintptr_t>(g->packed) % 16 == 0;
}

// COUNT as in launch_k2_ranges.
template <bool PAIR, bool COUNT = false>
int launch_k4(int device, const AwfmTables* t, const NgramTables* g,
              const uint32_t* seed_table, int64_t seed_rows, int k,
              const uint8_t* mat, int64_t b, int64_t l_pad, int kmer_len,
              int64_t* start_out, int64_t* end_out, cudaStream_t stream,
              unsigned long long* row_steps = nullptr) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (t->n_planes != 3 || !rows_fit<Narrow>(t) || !pair_rows_fit<Narrow, PAIR>(t) ||
      !ngram_rows_fit(g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (g->n == 2) {
    launch_k4_letters<2, PAIR, COUNT>(t, g, seed_table, seed_rows, k, mat, b, l_pad, kmer_len,
                                      start_out, end_out, row_steps, stream);
  } else if (g->n == 3) {
    launch_k4_letters<3, PAIR, COUNT>(t, g, seed_table, seed_rows, k, mat, b, l_pad, kmer_len,
                                      start_out, end_out, row_steps, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int awfm_k1_occ(int device, const AwfmTables* t, const int64_t* pos,
                const int32_t* letters, int64_t n, int64_t* out,
                cudaStream_t stream) {
  return launch_k1_occ<Narrow>(device, t, pos, letters, n, out, stream);
}

int awfm_k1w_occ(int device, const AwfmTables* t, const int64_t* pos,
                 const int32_t* letters, int64_t n, int64_t* out,
                 cudaStream_t stream) {
  return launch_k1_occ<Wide>(device, t, pos, letters, n, out, stream);
}

int awfm_k1_letter_lf(int device, const AwfmTables* t, const int64_t* pos,
                      int64_t n, int32_t* letters_out, int64_t* lf_out,
                      cudaStream_t stream) {
  return launch_k1_letter_lf<Narrow>(device, t, pos, n, letters_out, lf_out,
                                     stream);
}

int awfm_k1w_letter_lf(int device, const AwfmTables* t, const int64_t* pos,
                       int64_t n, int32_t* letters_out, int64_t* lf_out,
                       cudaStream_t stream) {
  return launch_k1_letter_lf<Wide>(device, t, pos, n, letters_out, lf_out,
                                   stream);
}

int awfm_k1w_compact_occ(int device, const AwfmTables* t, const int64_t* pos,
                         const int32_t* letters, int64_t n, int64_t* out,
                         cudaStream_t stream) {
  return launch_k1_occ<WideCompact>(device, t, pos, letters, n, out, stream);
}

int awfm_k1w_compact_letter_lf(int device, const AwfmTables* t, const int64_t* pos,
                               int64_t n, int32_t* letters_out, int64_t* lf_out,
                               cudaStream_t stream) {
  return launch_k1_letter_lf<WideCompact>(device, t, pos, n, letters_out, lf_out,
                                          stream);
}

// K1's single-query modes: (newStart, newEnd), or (letter, LF), into out[0..1].
int awfm_k1_step(int device, const AwfmTables* t, uint64_t start, uint64_t end,
                 uint32_t letter, int64_t* out, cudaStream_t stream) {
  return launch_k1_step<Narrow>(device, t, start, end, letter, out, stream);
}

int awfm_k1w_step(int device, const AwfmTables* t, uint64_t start, uint64_t end,
                  uint32_t letter, int64_t* out, cudaStream_t stream) {
  return launch_k1_step<Wide>(device, t, start, end, letter, out, stream);
}

int awfm_k1w_compact_step(int device, const AwfmTables* t, uint64_t start, uint64_t end,
                          uint32_t letter, int64_t* out, cudaStream_t stream) {
  return launch_k1_step<WideCompact>(device, t, start, end, letter, out, stream);
}

int awfm_k1_lf_at(int device, const AwfmTables* t, uint64_t pos, int64_t* out,
                  cudaStream_t stream) {
  return launch_k1_lf_at<Narrow>(device, t, pos, out, stream);
}

int awfm_k1w_lf_at(int device, const AwfmTables* t, uint64_t pos, int64_t* out,
                   cudaStream_t stream) {
  return launch_k1_lf_at<Wide>(device, t, pos, out, stream);
}

int awfm_k1w_compact_lf_at(int device, const AwfmTables* t, uint64_t pos, int64_t* out,
                           cudaStream_t stream) {
  return launch_k1_lf_at<WideCompact>(device, t, pos, out, stream);
}

// The readback of a single-query call: `bytes` from `src` (device) to `host`
// (pinned) on the stream, then the stream's own synchronisation, so the
// host reads what the call's launch wrote and nothing later in the stream.
int awfm_read_back(int device, void* host, const void* src, int64_t bytes,
                   cudaStream_t stream) {
  cudaError_t err = use_device(device);
  if (err == cudaSuccess) {
    err = cudaMemcpyAsync(host, src, static_cast<size_t>(bytes), cudaMemcpyDeviceToHost, stream);
  }
  if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
  return static_cast<int>(err);
}

int awfm_empty(int device, cudaStream_t stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  empty_kernel<<<1, 1, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}

int awfm_k1r_route(int device, int wide, const int64_t* pos, int64_t n,
                   int32_t n_shards, int32_t bps, uint64_t ratio, int64_t unowned,
                   int64_t* out, int64_t* off, int32_t* letters_out,
                   int64_t* slot_pos, int32_t* slot_lane, uint32_t* counts,
                   cudaStream_t stream) {
  if (wide) {
    return launch_k1r_route<Wide>(device, pos, n, n_shards, bps, ratio, unowned, out, off,
                                  letters_out, slot_pos, slot_lane, counts, stream);
  }
  return launch_k1r_route<Narrow>(device, pos, n, n_shards, bps, ratio, unowned, out, off,
                                  letters_out, slot_pos, slot_lane, counts, stream);
}

int awfm_k1r_occ(int device, const AwfmTables* t, int32_t first_block,
                 const int64_t* slot_pos, const int32_t* slot_lane,
                 const uint32_t* counts, int32_t shard, int64_t count,
                 int64_t capacity, const int32_t* letters, int64_t* out,
                 cudaStream_t stream) {
  return launch_k1r_occ<Narrow>(device, t, first_block, slot_pos, slot_lane, counts, shard,
                                count, capacity, letters, out, stream);
}

int awfm_k1rw_occ(int device, const AwfmTables* t, int32_t first_block,
                  const int64_t* slot_pos, const int32_t* slot_lane,
                  const uint32_t* counts, int32_t shard, int64_t count,
                  int64_t capacity, const int32_t* letters, int64_t* out,
                  cudaStream_t stream) {
  return launch_k1r_occ<WideCompact>(device, t, first_block, slot_pos, slot_lane, counts,
                                     shard, count, capacity, letters, out, stream);
}

int awfm_k1r_lf(int device, const AwfmTables* t, int32_t first_block,
                const int64_t* slot_pos, const int32_t* slot_lane,
                const uint32_t* counts, int32_t shard, int64_t count,
                int64_t capacity, int64_t* p_out, int32_t* letters_out,
                cudaStream_t stream) {
  return launch_k1r_lf<Narrow>(device, t, first_block, slot_pos, slot_lane, counts, shard,
                               count, capacity, p_out, letters_out, stream);
}

int awfm_k1rw_lf(int device, const AwfmTables* t, int32_t first_block,
                 const int64_t* slot_pos, const int32_t* slot_lane,
                 const uint32_t* counts, int32_t shard, int64_t count,
                 int64_t capacity, int64_t* p_out, int32_t* letters_out,
                 cudaStream_t stream) {
  return launch_k1r_lf<WideCompact>(device, t, first_block, slot_pos, slot_lane, counts,
                                    shard, count, capacity, p_out, letters_out, stream);
}

int awfm_k1_extend(int device, const AwfmTables* t, const uint32_t* table,
                   int64_t n, uint32_t* nxt, cudaStream_t stream) {
  return launch_k1_extend<Narrow>(device, t, table, n, nxt, stream);
}

int awfm_k1w_extend(int device, const AwfmTables* t, const uint64_t* table,
                    int64_t n, uint64_t* nxt, cudaStream_t stream) {
  return launch_k1_extend<Wide>(device, t, table, n, nxt, stream);
}

int awfm_k1w_compact_extend(int device, const AwfmTables* t, const uint64_t* table,
                            int64_t n, uint64_t* nxt, cudaStream_t stream) {
  return launch_k1_extend<WideCompact>(device, t, table, n, nxt, stream);
}

// K1X's BFS mode (K1WX's for a wide view, over compact rows for one without
// pair rows): the first `levels` levels of the seed table in one launch.
int awfm_k1_seed_table(int device, const AwfmTables* t, int levels, uint8_t* scratch,
                       int64_t scratch_bytes, uint32_t* out, cudaStream_t stream) {
  return launch_k1_seed_table<Narrow>(device, t, levels, scratch, scratch_bytes, out, stream);
}

int awfm_k1w_seed_table(int device, const AwfmTables* t, int levels, uint8_t* scratch,
                        int64_t scratch_bytes, uint64_t* out, cudaStream_t stream) {
  return launch_k1_seed_table<Wide>(device, t, levels, scratch, scratch_bytes, out, stream);
}

int awfm_k1w_compact_seed_table(int device, const AwfmTables* t, int levels, uint8_t* scratch,
                                int64_t scratch_bytes, uint64_t* out, cudaStream_t stream) {
  return launch_k1_seed_table<WideCompact>(device, t, levels, scratch, scratch_bytes, out,
                                           stream);
}

// The bytes of scratch the BFS mode takes for a table of `levels` levels.
int64_t awfm_seed_table_scratch_bytes(int64_t card, int levels, int64_t pos_bytes) {
  return seed_table_scratch_bytes(card, levels, pos_bytes);
}

// row_steps: null, or the two counters of RowSteps (the steps by class),
// which the launch adds to.
int awfm_k2_ranges(int device, const AwfmTables* t, const uint32_t* seed_table,
                   int64_t seed_rows, int k, const uint8_t* mat, int64_t b,
                   int64_t l_pad, const int32_t* lengths, const uint8_t* seeded,
                   int64_t* start_out, int64_t* end_out,
                   unsigned long long* row_steps, cudaStream_t stream) {
  if (row_steps != nullptr) {
    return launch_k2_ranges<Narrow, true, true>(device, t, seed_table, seed_rows, k, mat,
                                                b, l_pad, lengths, seeded, start_out,
                                                end_out, stream, row_steps);
  }
  return launch_k2_ranges<Narrow, true>(device, t, seed_table, seed_rows, k, mat, b,
                                        l_pad, lengths, seeded, start_out, end_out,
                                        stream);
}

// row_steps as in awfm_k2_ranges.
int awfm_k2_block_ranges(int device, const AwfmTables* t, const uint32_t* seed_table,
                         int64_t seed_rows, int k, const uint8_t* mat, int64_t b,
                         int64_t l_pad, const int32_t* lengths, const uint8_t* seeded,
                         int64_t* start_out, int64_t* end_out,
                         unsigned long long* row_steps, cudaStream_t stream) {
  if (row_steps != nullptr) {
    return launch_k2_ranges<Narrow, false, true>(device, t, seed_table, seed_rows, k, mat,
                                                 b, l_pad, lengths, seeded, start_out,
                                                 end_out, stream, row_steps);
  }
  return launch_k2_ranges<Narrow, false>(device, t, seed_table, seed_rows, k, mat, b,
                                         l_pad, lengths, seeded, start_out, end_out,
                                         stream);
}

// row_steps as in awfm_k2_ranges.
int awfm_k2w_ranges(int device, const AwfmTables* t, const uint64_t* seed_table,
                    int64_t seed_rows, int k, const uint8_t* mat, int64_t b,
                    int64_t l_pad, const int32_t* lengths,
                    const uint8_t* seeded, int64_t* start_out,
                    int64_t* end_out, unsigned long long* row_steps,
                    cudaStream_t stream) {
  if (row_steps != nullptr) {
    return launch_k2_ranges<Wide, true, true>(device, t, seed_table, seed_rows, k, mat, b,
                                              l_pad, lengths, seeded, start_out, end_out,
                                              stream, row_steps);
  }
  return launch_k2_ranges<Wide, true>(device, t, seed_table, seed_rows, k, mat, b,
                                      l_pad, lengths, seeded, start_out, end_out,
                                      stream);
}

int awfm_k2w_compact_ranges(int device, const AwfmTables* t, const uint64_t* seed_table,
                            int64_t seed_rows, int k, const uint8_t* mat, int64_t b,
                            int64_t l_pad, const int32_t* lengths,
                            const uint8_t* seeded, int64_t* start_out,
                            int64_t* end_out, cudaStream_t stream) {
  return launch_k2_ranges<WideCompact, false>(device, t, seed_table, seed_rows, k, mat, b,
                                              l_pad, lengths, seeded, start_out, end_out,
                                              stream);
}

int awfm_k3_backtrace_resolve(int device, const AwfmTables* t,
                              const int64_t* pos, int64_t n, uint32_t ratio,
                              uint32_t bwt_length, const uint32_t* sa,
                              int64_t* hits_out, int64_t* p_out,
                              int64_t* off_out, cudaStream_t stream) {
  return launch_k3_backtrace_resolve<Narrow>(device, t, pos, n, ratio,
                                             bwt_length, sa, hits_out, p_out,
                                             off_out, stream);
}

int awfm_k3w_backtrace_resolve(int device, const AwfmTables* t,
                               const int64_t* pos, int64_t n, uint64_t ratio,
                               uint64_t bwt_length, const uint64_t* sa,
                               int64_t* hits_out, int64_t* p_out,
                               int64_t* off_out, cudaStream_t stream) {
  return launch_k3_backtrace_resolve<Wide>(device, t, pos, n, ratio,
                                           bwt_length, sa, hits_out, p_out,
                                           off_out, stream);
}

// K3w over compact wide rows (WideCompact: planes 32 B apart, so a
// nucleotide visit touches two 64 B pieces, not four): the backtrace of a
// wide view without pair rows.
int awfm_k3w_compact_backtrace_resolve(int device, const AwfmTables* t,
                                       const int64_t* pos, int64_t n, uint64_t ratio,
                                       uint64_t bwt_length, const uint64_t* sa,
                                       int64_t* hits_out, int64_t* p_out,
                                       int64_t* off_out, cudaStream_t stream) {
  return launch_k3_backtrace_resolve<WideCompact>(device, t, pos, n, ratio,
                                                  bwt_length, sa, hits_out,
                                                  p_out, off_out, stream);
}

// row_steps as in awfm_k2_ranges: the tail steps by class.
int awfm_k4_ngram_ranges(int device, const AwfmTables* t, const NgramTables* g,
                         const uint32_t* seed_table, int64_t seed_rows, int k,
                         const uint8_t* mat, int64_t b, int64_t l_pad,
                         int kmer_len, int64_t* start_out, int64_t* end_out,
                         unsigned long long* row_steps, cudaStream_t stream) {
  if (row_steps != nullptr) {
    return launch_k4<true, true>(device, t, g, seed_table, seed_rows, k, mat, b, l_pad,
                                 kmer_len, start_out, end_out, stream, row_steps);
  }
  return launch_k4<true>(device, t, g, seed_table, seed_rows, k, mat, b, l_pad,
                         kmer_len, start_out, end_out, stream);
}

// row_steps as in awfm_k2_ranges: the tail steps by class.
int awfm_k4_block_ngram_ranges(int device, const AwfmTables* t, const NgramTables* g,
                               const uint32_t* seed_table, int64_t seed_rows, int k,
                               const uint8_t* mat, int64_t b, int64_t l_pad,
                               int kmer_len, int64_t* start_out, int64_t* end_out,
                               unsigned long long* row_steps, cudaStream_t stream) {
  if (row_steps != nullptr) {
    return launch_k4<false, true>(device, t, g, seed_table, seed_rows, k, mat, b, l_pad,
                                  kmer_len, start_out, end_out, stream, row_steps);
  }
  return launch_k4<false>(device, t, g, seed_table, seed_rows, k, mat, b, l_pad,
                          kmer_len, start_out, end_out, stream);
}

const char* awfm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
