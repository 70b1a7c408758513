// Native KITTI detection-mAP evaluator (a copy of
// squeezedet_tpu/native/kitti_eval/evaluate_object.cc, built by
// squeezedet_torch/native/__init__.py into squeezedet_torch/_build/).
//
// Reimplementation of the official KITTI benchmark protocol; the Python
// twin squeezedet_torch/data/kitti_ap.py is kept bit-equivalent and serves
// as the parity oracle in tests/test_torch_kitti_eval.py.
//
// CLI (the same as the JAX package's evaluator):
//   evaluate_object <kitti_training_dir> <image_set.txt> <result_dir> <N>
// where <kitti_training_dir>/label_2/<idx>.txt holds ground truth and
// <result_dir>/data/<idx>.txt holds detections.  Writes
// stats_<cls>_ap.txt (3 lines "AP=<v>"), stats_<cls>_detection.txt,
// stats_<cls>_orientation.txt (when every detection carries a valid
// alpha) and plot/<cls>_detection.txt PR data.  No gnuplot/mail
// dependencies.
//
// Protocol summary: per class x {easy, moderate, hard} difficulty,
// ground truth outside the difficulty's occlusion/truncation/height
// bounds is "ignored" (neither TP nor FN), neighboring classes
// (van<->car, person_sitting<->pedestrian) are ignored, DontCare areas
// absorb otherwise-unmatched detections; recall is discretized to 41
// sample points via score thresholds; precision is max-filtered from the
// right; AP is the mean of 11 equally spaced points.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <sys/stat.h>
#include <vector>

namespace {

constexpr int kNumSamplePts = 41;
constexpr double kNoDetection = -10000000.0;

const char* kClassNames[3] = {"car", "pedestrian", "cyclist"};
const int kMinHeight[3] = {40, 25, 25};
const int kMaxOcclusion[3] = {0, 1, 2};
const double kMaxTruncation[3] = {0.15, 0.3, 0.5};
const double kMinOverlap[3] = {0.7, 0.5, 0.5};  // per class

struct GroundTruth {
  std::string type;  // lower-cased
  double truncation = -1;
  int occlusion = -1;
  double alpha = -10;
  double x1 = -1, y1 = -1, x2 = -1, y2 = -1;
};

struct Detection {
  std::string type;  // lower-cased
  double alpha = -10;
  double x1 = -1, y1 = -1, x2 = -1, y2 = -1;
  double score = -1000;
};

struct PrPoint {
  long tp = 0, fp = 0, fn = 0;
  double similarity = 0;
};

std::string Lower(std::string s) {
  for (auto& c : s) c = static_cast<char>(std::tolower(c));
  return s;
}

bool LoadGroundTruth(const std::string& path, std::vector<GroundTruth>* out) {
  std::ifstream f(path);
  if (!f) return false;
  std::string line;
  while (std::getline(f, line)) {
    std::istringstream is(line);
    GroundTruth g;
    double trash;
    if (is >> g.type >> g.truncation >> g.occlusion >> g.alpha >> g.x1 >>
        g.y1 >> g.x2 >> g.y2 >> trash >> trash >> trash >> trash >> trash >>
        trash >> trash) {
      g.type = Lower(g.type);
      out->push_back(g);
    }
  }
  return true;
}

bool LoadDetections(const std::string& path, std::vector<Detection>* out) {
  std::ifstream f(path);
  if (!f) return false;
  std::string line;
  while (std::getline(f, line)) {
    std::istringstream is(line);
    Detection d;
    double trash;
    if (is >> d.type >> trash >> trash >> d.alpha >> d.x1 >> d.y1 >> d.x2 >>
        d.y2 >> trash >> trash >> trash >> trash >> trash >> trash >> trash >>
        d.score) {
      d.type = Lower(d.type);
      out->push_back(d);
    }
  }
  return true;
}

// criterion -1: IoU; 0: intersection / area(a) (for DontCare absorption).
template <typename A, typename B>
double BoxOverlap(const A& a, const B& b, int criterion = -1) {
  const double x1 = std::max(a.x1, b.x1);
  const double y1 = std::max(a.y1, b.y1);
  const double x2 = std::min(a.x2, b.x2);
  const double y2 = std::min(a.y2, b.y2);
  const double w = x2 - x1, h = y2 - y1;
  if (w <= 0 || h <= 0) return 0;
  const double inter = w * h;
  const double a_area = (a.x2 - a.x1) * (a.y2 - a.y1);
  const double b_area = (b.x2 - b.x1) * (b.y2 - b.y1);
  if (criterion == 0) return inter / a_area;
  if (criterion == 1) return inter / b_area;
  return inter / (a_area + b_area - inter);
}

// Score thresholds that discretize recall into kNumSamplePts steps.
std::vector<double> GetThresholds(std::vector<double> scores, double n_gt) {
  std::sort(scores.begin(), scores.end(), std::greater<double>());
  std::vector<double> t;
  double current_recall = 0;
  for (size_t i = 0; i < scores.size(); ++i) {
    const double l_recall = (i + 1) / n_gt;
    const double r_recall =
        (i < scores.size() - 1) ? (i + 2) / n_gt : l_recall;
    if ((r_recall - current_recall) < (current_recall - l_recall) &&
        i < scores.size() - 1)
      continue;
    t.push_back(scores[i]);
    current_recall += 1.0 / (kNumSamplePts - 1.0);
  }
  return t;
}

struct CleanResult {
  std::vector<int> ignored_gt;   // 0 valid, 1 ignored, -1 other class
  std::vector<int> ignored_det;  // 0 this class, -1 other class
  std::vector<GroundTruth> dontcare;
  int n_gt = 0;
};

CleanResult CleanData(int cls, const std::vector<GroundTruth>& gt,
                      const std::vector<Detection>& det, int difficulty) {
  CleanResult r;
  const std::string cls_name = kClassNames[cls];
  for (const auto& g : gt) {
    const double height = g.y2 - g.y1;
    int valid_class;
    if (g.type == cls_name) {
      valid_class = 1;
    } else if (cls_name == "pedestrian" && g.type == "person_sitting") {
      valid_class = 0;
    } else if (cls_name == "car" && g.type == "van") {
      valid_class = 0;
    } else {
      valid_class = -1;
    }
    const bool ignore = g.occlusion > kMaxOcclusion[difficulty] ||
                        g.truncation > kMaxTruncation[difficulty] ||
                        height < kMinHeight[difficulty];
    if (valid_class == 1 && !ignore) {
      r.ignored_gt.push_back(0);
      ++r.n_gt;
    } else if (valid_class == 0 || (ignore && valid_class == 1)) {
      r.ignored_gt.push_back(1);
    } else {
      r.ignored_gt.push_back(-1);
    }
  }
  for (const auto& g : gt)
    if (g.type == "dontcare") r.dontcare.push_back(g);
  for (const auto& d : det)
    r.ignored_det.push_back(d.type == cls_name ? 0 : -1);
  return r;
}

// One image's statistics at a score threshold.  When !compute_fp, only
// TP scores are collected (first pass for recall discretization).
PrPoint ComputeStatistics(int cls, const std::vector<GroundTruth>& gt,
                          const std::vector<Detection>& det,
                          const CleanResult& clean, bool compute_fp,
                          bool compute_aos, double thresh,
                          std::vector<double>* tp_scores) {
  PrPoint stat;
  const double min_overlap = kMinOverlap[cls];
  std::vector<bool> assigned(det.size(), false);
  std::vector<bool> ignored_threshold(det.size(), false);
  std::vector<double> delta;
  if (compute_fp)
    for (size_t j = 0; j < det.size(); ++j)
      if (det[j].score < thresh) ignored_threshold[j] = true;

  for (size_t i = 0; i < gt.size(); ++i) {
    if (clean.ignored_gt[i] == -1) continue;
    int det_idx = -1;
    double valid_detection = kNoDetection;
    double max_overlap = 0;
    bool assigned_ignored_det = false;
    for (size_t j = 0; j < det.size(); ++j) {
      if (clean.ignored_det[j] == -1 || assigned[j] || ignored_threshold[j])
        continue;
      const double overlap = BoxOverlap(det[j], gt[i]);
      if (!compute_fp && overlap > min_overlap &&
          det[j].score > valid_detection) {
        det_idx = static_cast<int>(j);
        valid_detection = det[j].score;
      } else if (compute_fp && overlap > min_overlap &&
                 (overlap > max_overlap || assigned_ignored_det) &&
                 clean.ignored_det[j] == 0) {
        max_overlap = overlap;
        det_idx = static_cast<int>(j);
        valid_detection = 1;
        assigned_ignored_det = false;
      } else if (compute_fp && overlap > min_overlap &&
                 valid_detection == kNoDetection &&
                 clean.ignored_det[j] == 1) {
        det_idx = static_cast<int>(j);
        valid_detection = 1;
        assigned_ignored_det = true;
      }
    }

    if (valid_detection == kNoDetection && clean.ignored_gt[i] == 0) {
      ++stat.fn;
    } else if (valid_detection != kNoDetection &&
               (clean.ignored_gt[i] == 1 ||
                clean.ignored_det[det_idx] == 1)) {
      assigned[det_idx] = true;
    } else if (valid_detection != kNoDetection) {
      ++stat.tp;
      if (tp_scores) tp_scores->push_back(det[det_idx].score);
      if (compute_aos) delta.push_back(gt[i].alpha - det[det_idx].alpha);
      assigned[det_idx] = true;
    }
  }

  if (compute_fp) {
    for (size_t j = 0; j < det.size(); ++j)
      if (!(assigned[j] || clean.ignored_det[j] == -1 ||
            clean.ignored_det[j] == 1 || ignored_threshold[j]))
        ++stat.fp;
    long nstuff = 0;
    for (const auto& dc : clean.dontcare) {
      for (size_t j = 0; j < det.size(); ++j) {
        if (assigned[j] || clean.ignored_det[j] == -1 ||
            clean.ignored_det[j] == 1 || ignored_threshold[j])
          continue;
        if (BoxOverlap(det[j], dc, 0) > min_overlap) {
          assigned[j] = true;
          ++nstuff;
        }
      }
    }
    stat.fp -= nstuff;
    if (compute_aos) {
      double sum = 0;
      for (double dlt : delta) sum += (1.0 + std::cos(dlt)) / 2.0;
      stat.similarity = (stat.tp > 0 || stat.fp > 0) ? sum : -1;
    }
  }
  return stat;
}

struct Curve {
  std::vector<double> precision;  // kNumSamplePts entries
  std::vector<double> aos;        // kNumSamplePts entries
};

Curve EvalClass(int cls, const std::vector<std::vector<GroundTruth>>& gts,
                const std::vector<std::vector<Detection>>& dets,
                int difficulty, bool compute_aos) {
  const size_t n_images = gts.size();
  std::vector<CleanResult> cleaned(n_images);
  std::vector<double> scores;
  long n_gt = 0;
  for (size_t i = 0; i < n_images; ++i) {
    cleaned[i] = CleanData(cls, gts[i], dets[i], difficulty);
    n_gt += cleaned[i].n_gt;
    ComputeStatistics(cls, gts[i], dets[i], cleaned[i], false, false, 0,
                      &scores);
  }
  const std::vector<double> thresholds =
      GetThresholds(scores, static_cast<double>(n_gt));

  std::vector<PrPoint> pr(thresholds.size());
  for (size_t i = 0; i < n_images; ++i) {
    for (size_t t = 0; t < thresholds.size(); ++t) {
      const PrPoint p = ComputeStatistics(cls, gts[i], dets[i], cleaned[i],
                                          true, compute_aos, thresholds[t],
                                          nullptr);
      pr[t].tp += p.tp;
      pr[t].fp += p.fp;
      pr[t].fn += p.fn;
      if (p.similarity != -1) pr[t].similarity += p.similarity;
    }
  }

  Curve c;
  c.precision.assign(kNumSamplePts, 0.0);
  c.aos.assign(kNumSamplePts, 0.0);
  for (size_t i = 0; i < thresholds.size(); ++i) {
    c.precision[i] =
        pr[i].tp / static_cast<double>(pr[i].tp + pr[i].fp);
    if (compute_aos)
      c.aos[i] = pr[i].similarity / static_cast<double>(pr[i].tp + pr[i].fp);
  }
  for (size_t i = 0; i < thresholds.size(); ++i) {
    c.precision[i] =
        *std::max_element(c.precision.begin() + i, c.precision.end());
    if (compute_aos)
      c.aos[i] = *std::max_element(c.aos.begin() + i, c.aos.end());
  }
  return c;
}

// 11-point AP over the 41-sample curve; reference prints via C++
// stringstream default precision (6 significant digits).
double ApFromPrecision(const std::vector<double>& precision) {
  double ap = 0;
  int cnt = 0;
  for (int i = 0; i < static_cast<int>(precision.size()); i += 4) {
    ap += precision[i];
    ++cnt;
  }
  return ap / cnt;
}

std::string FormatG6(double v) {
  std::ostringstream os;
  os << v;  // default: 6 significant digits, matching reference output
  return os.str();
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 5) {
    std::fprintf(stderr,
                 "Usage: %s <kitti_training_dir> <image_set.txt> "
                 "<result_dir> <n_images>\n",
                 argv[0]);
    return 1;
  }
  const std::string gt_dir = std::string(argv[1]) + "/label_2";
  const std::string image_set_filename = argv[2];
  const std::string result_dir = argv[3];
  const long n_images = std::atol(argv[4]);

  std::vector<std::string> image_set;
  {
    std::ifstream f(image_set_filename);
    if (!f) {
      std::fprintf(stderr, "ERROR: couldn't read image set file %s\n",
                   image_set_filename.c_str());
      return 1;
    }
    std::string idx;
    while (f >> idx) image_set.push_back(idx);
  }
  if (static_cast<long>(image_set.size()) != n_images) {
    std::fprintf(stderr, "ERROR: image set has %zu entries, expected %ld\n",
                 image_set.size(), n_images);
    return 1;
  }

  std::vector<std::vector<GroundTruth>> gts(image_set.size());
  std::vector<std::vector<Detection>> dets(image_set.size());
  bool compute_aos = true;
  bool seen[3] = {false, false, false};
  for (size_t i = 0; i < image_set.size(); ++i) {
    if (!LoadGroundTruth(gt_dir + "/" + image_set[i] + ".txt", &gts[i])) {
      std::fprintf(stderr, "ERROR: couldn't read ground truth %s.txt\n",
                   image_set[i].c_str());
      return 1;
    }
    if (!LoadDetections(result_dir + "/data/" + image_set[i] + ".txt",
                        &dets[i])) {
      std::fprintf(stderr, "ERROR: couldn't read detections %s.txt\n",
                   image_set[i].c_str());
      return 1;
    }
    for (const auto& d : dets[i]) {
      if (d.alpha == -10) compute_aos = false;
      for (int c = 0; c < 3; ++c)
        if (d.type == kClassNames[c]) seen[c] = true;
    }
  }

  const std::string plot_dir = result_dir + "/plot";
  ::mkdir(plot_dir.c_str(), 0777);

  for (int cls = 0; cls < 3; ++cls) {
    if (!seen[cls]) continue;
    const std::string name = kClassNames[cls];
    Curve curves[3];
    for (int difficulty = 0; difficulty < 3; ++difficulty)
      curves[difficulty] = EvalClass(cls, gts, dets, difficulty,
                                     compute_aos);

    std::ofstream ap_file(result_dir + "/stats_" + name + "_ap.txt");
    std::ofstream det_file(result_dir + "/stats_" + name +
                           "_detection.txt");
    std::ofstream ori_file;
    if (compute_aos)
      ori_file.open(result_dir + "/stats_" + name + "_orientation.txt");
    for (int difficulty = 0; difficulty < 3; ++difficulty) {
      const auto& prec = curves[difficulty].precision;
      ap_file << "AP=" << FormatG6(ApFromPrecision(prec)) << "\n";
      char buf[64];
      for (int i = 0; i < kNumSamplePts; i += 4) {
        std::snprintf(buf, sizeof buf, "%f ", prec[i]);
        det_file << buf;
      }
      det_file << "\n";
      if (compute_aos) {
        for (int i = 0; i < kNumSamplePts; ++i) {
          std::snprintf(buf, sizeof buf, "%f ", curves[difficulty].aos[i]);
          ori_file << buf;
        }
        ori_file << "\n";
      }
    }

    std::ofstream plot(plot_dir + "/" + name + "_detection.txt");
    for (int i = 0; i < kNumSamplePts; ++i) {
      char buf[128];
      std::snprintf(buf, sizeof buf, "%f %f %f %f\n",
                    i / (kNumSamplePts - 1.0), curves[0].precision[i],
                    curves[1].precision[i], curves[2].precision[i]);
      plot << buf;
    }
    if (compute_aos) {
      std::ofstream ori_plot(plot_dir + "/" + name + "_orientation.txt");
      for (int i = 0; i < kNumSamplePts; ++i) {
        char buf[128];
        std::snprintf(buf, sizeof buf, "%f %f %f %f\n",
                      i / (kNumSamplePts - 1.0), curves[0].aos[i],
                      curves[1].aos[i], curves[2].aos[i]);
        ori_plot << buf;
      }
    }
  }
  std::printf("Evaluation results written to %s\n", result_dir.c_str());
  return 0;
}
