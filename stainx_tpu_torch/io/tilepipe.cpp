// tilepipe — threaded host-side tile ingestion for device feeding.
//
// The port's copy of stainx_tpu/io/tilepipe.cpp: a pool of reader threads
// fills pre-allocated batch buffers from raw tile files, so host IO
// overlaps the card's compute. Exposed through a minimal C ABI consumed via
// ctypes; buffers are handed to Python as zero-copy views. The slots are
// page-aligned buffers of its own, or buffers the caller owns (tp_open's
// `buffers`): the page-locked host tensors the loader copies to the card
// from, so the reads land where the copy reads.
//
// Build: g++ -O2 -shared -fPIC -pthread -std=c++17 tilepipe.cpp -o <lib>.so
// (stainx_tpu_torch/io/tilepipe.py builds it on first use into
// build/stainx_tpu_torch/, under a name that hashes this source).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct ReadTask {
    int slot;
    std::string path;
    size_t offset;   // byte offset inside the slot buffer
    size_t length;   // expected bytes (file must be at least this long)
};

struct Slot {
    uint8_t* data = nullptr;
    std::atomic<int> pending{0};  // outstanding reads
    std::atomic<int> errors{0};
};

struct Pipe {
    size_t slot_bytes = 0;
    bool owns_slots = true;  // false: the caller owns the slot buffers
    std::vector<Slot> slots;
    std::vector<std::thread> workers;

    std::mutex mu;
    std::condition_variable cv_work;
    std::condition_variable cv_done;
    std::queue<ReadTask> tasks;
    bool shutdown = false;

    ~Pipe() {
        {
            std::lock_guard<std::mutex> lock(mu);
            shutdown = true;
        }
        cv_work.notify_all();
        for (auto& t : workers) t.join();
        if (owns_slots) {
            for (auto& s : slots) std::free(s.data);
        }
    }

    void worker() {
        for (;;) {
            ReadTask task;
            {
                std::unique_lock<std::mutex> lock(mu);
                cv_work.wait(lock, [&] { return shutdown || !tasks.empty(); });
                if (shutdown && tasks.empty()) return;
                task = std::move(tasks.front());
                tasks.pop();
            }
            Slot& slot = slots[task.slot];
            bool ok = false;
            // Subtract-form bound: `offset + length` can wrap size_t for
            // garbage inputs, turning the range check into an OOB write.
            if (task.length <= slot_bytes && task.offset <= slot_bytes - task.length) {
                FILE* f = std::fopen(task.path.c_str(), "rb");
                if (f) {
                    size_t got = std::fread(slot.data + task.offset, 1, task.length, f);
                    std::fclose(f);
                    ok = (got == task.length);
                }
            }
            if (!ok) slot.errors.fetch_add(1);
            // The pending decrement must happen under the waiter's mutex:
            // a bare atomic fetch_sub + notify can fire between tp_wait's
            // predicate check and its block, losing the wakeup forever.
            {
                std::lock_guard<std::mutex> lock(mu);
                if (slot.pending.fetch_sub(1) == 1) cv_done.notify_all();
            }
        }
    }
};

}  // namespace

extern "C" {

// `buffers`: null, for page-aligned slots allocated here, or n_slots
// caller-owned buffers of slot_bytes each, which must outlive tp_close.
void* tp_open(size_t slot_bytes, int n_slots, int n_threads, uint8_t* const* buffers) {
    // Reject degenerate configurations at the boundary: zero threads turns
    // the first tp_wait into a permanent deadlock (work enqueued, nobody
    // to drain it), and a negative n_slots casts to a huge size_t vector
    // size (std::bad_alloc escaping the C ABI).
    if (slot_bytes == 0 || n_slots < 1 || n_threads < 1) return nullptr;
    if (buffers != nullptr) {
        for (int i = 0; i < n_slots; ++i) {
            if (buffers[i] == nullptr) return nullptr;
        }
    }
    auto* p = new Pipe();
    p->slot_bytes = slot_bytes;
    p->slots = std::vector<Slot>(static_cast<size_t>(n_slots));
    if (buffers != nullptr) {
        p->owns_slots = false;
        for (int i = 0; i < n_slots; ++i) p->slots[static_cast<size_t>(i)].data = buffers[i];
    } else {
        for (auto& s : p->slots) {
            void* mem = nullptr;
            if (posix_memalign(&mem, 4096, slot_bytes) != 0) {
                // POSIX leaves *memptr undefined on failure: keep this slot's
                // pointer null so ~Pipe()'s free() of every slot stays defined.
                s.data = nullptr;
                delete p;
                return nullptr;
            }
            s.data = static_cast<uint8_t*>(mem);
        }
    }
    for (int i = 0; i < n_threads; ++i) {
        p->workers.emplace_back([p] { p->worker(); });
    }
    return p;
}

// Enqueue n file reads into `slot` (paths NUL-separated); returns 0 on OK.
int tp_enqueue(void* handle, int slot, const char* paths, const uint64_t* offsets,
               const uint64_t* lengths, int n) {
    auto* p = static_cast<Pipe*>(handle);
    if (slot < 0 || static_cast<size_t>(slot) >= p->slots.size()) return -1;
    Slot& s = p->slots[static_cast<size_t>(slot)];
    s.errors.store(0);
    s.pending.fetch_add(n);
    {
        std::lock_guard<std::mutex> lock(p->mu);
        const char* cursor = paths;
        for (int i = 0; i < n; ++i) {
            ReadTask t;
            t.slot = slot;
            t.path = cursor;
            t.offset = offsets[i];
            t.length = lengths[i];
            cursor += t.path.size() + 1;
            p->tasks.push(std::move(t));
        }
    }
    p->cv_work.notify_all();
    return 0;
}

// Block until every read enqueued into `slot` finished; returns the number
// of failed reads (0 = success, -1 = invalid slot).
int tp_wait(void* handle, int slot) {
    auto* p = static_cast<Pipe*>(handle);
    if (slot < 0 || static_cast<size_t>(slot) >= p->slots.size()) return -1;
    Slot& s = p->slots[static_cast<size_t>(slot)];
    std::unique_lock<std::mutex> lock(p->mu);
    p->cv_done.wait(lock, [&] { return s.pending.load() == 0; });
    return s.errors.load();
}

uint8_t* tp_buffer(void* handle, int slot) {
    auto* p = static_cast<Pipe*>(handle);
    if (slot < 0 || static_cast<size_t>(slot) >= p->slots.size()) return nullptr;
    return p->slots[static_cast<size_t>(slot)].data;
}

void tp_close(void* handle) { delete static_cast<Pipe*>(handle); }

}  // extern "C"
